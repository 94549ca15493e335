"""Claim-lifecycle tracing in the port, held against the JAX package.

The span library, context propagation through object annotations, the
trace audit and phase breakdown, fault annotation, the ``/debug/traces``
endpoint and one trace stitching a claim's whole lifecycle on the GPU
plugin stack (``MockDeviceLib("h100-8")``) — the tracing classes of
``tests/test_observability.py`` — and the trace exemplars and prepare span
events of ``tests/test_blackbox.py``, on the port's modules.
``TestAgainstJax`` holds the traceparent codec, the annotation carried
between the two packages, and the audit and breakdown functions against
the JAX package, and reads a complete claim trace from a GPU plugin
process started with ``--trace true``.
"""

import io
import json
import logging as stdlogging
import os
import random
import re
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from k8s_dra_driver_tpu.pkg import tracing as jax_tracing
from k8s_dra_driver_tpu_torch.internal.common import standard_debug_handlers
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.k8sclient.httpapi import ApiServer, HttpClient
from k8s_dra_driver_tpu_torch.pkg import (
    blackbox,
    events,
    faultpoints,
    tracing,
)
from k8s_dra_driver_tpu_torch.pkg import logging as port_logging
from k8s_dra_driver_tpu_torch.pkg.metrics import (
    DRAMetrics,
    Histogram,
    MetricsServer,
    Registry,
)
from k8s_dra_driver_tpu_torch.pkg.telemetry import (
    collect_exemplars,
    parse_exposition,
    render_exposition,
    semantic_samples,
)

REPO = str(__import__("pathlib").Path(__file__).resolve().parent.parent)
DRIVER = "gpu.nvidia.com"


@pytest.fixture(autouse=True)
def _fresh_tracer():
    tracing._reset_for_tests()
    yield
    tracing._reset_for_tests()


def _gpu_class(client):
    client.create(new_object(
        "DeviceClass", DRIVER, spec={"selectors": [{"cel": {
            "expression": "device.attributes['type'] == 'gpu'"}}]}))


def _claim_obj(name, namespace="default"):
    return new_object(
        "ResourceClaim", name, namespace,
        api_version="resource.k8s.io/v1",
        spec={"devices": {"requests": [{
            "name": "gpu", "exactly": {
                "deviceClassName": DRIVER,
                "allocationMode": "ExactCount", "count": 1}}]}})


def _until(cond, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


# ---------------------------------------------------------------------------
# tracing core
# ---------------------------------------------------------------------------

class TestTracingCore:
    def test_disabled_is_noop(self):
        span = tracing.start_span("x")
        assert span is tracing.NOOP_SPAN
        assert not span.recording
        with tracing.child_span("y") as c:
            assert c is tracing.NOOP_SPAN
        assert len(tracing.default_tracer().store) == 0

    def test_nesting_parents_onto_active_span(self):
        tracing.enable(capacity=100)
        with tracing.start_span("root") as root:
            with tracing.child_span("mid") as mid:
                assert mid.parent_id == root.span_id
                with tracing.child_span("leaf") as leaf:
                    assert leaf.parent_id == mid.span_id
                    assert leaf.trace_id == root.trace_id
        traces = tracing.default_tracer().store.traces()
        assert len(traces) == 1
        assert not tracing.audit_traces(traces)

    def test_child_span_never_mints_roots(self):
        tracing.enable(capacity=100)
        with tracing.child_span("orphan-would-be"):
            pass
        assert len(tracing.default_tracer().store) == 0

    def test_new_root_ignores_active_span(self):
        tracing.enable(capacity=100)
        outer = tracing.start_span("outer")
        inner = tracing.start_span("inner", new_root=True, activate=False)
        assert inner.parent_id == ""
        assert inner.trace_id != outer.trace_id
        inner.set_status("ok")
        inner.end()
        outer.set_status("ok")
        outer.end()

    def test_context_manager_records_exception_as_error(self):
        tracing.enable(capacity=100)
        with pytest.raises(ValueError):
            with tracing.start_span("boom") as span:
                raise ValueError("nope")
        assert span.status == "error"
        assert "nope" in span.status_message
        assert span.end_ts > 0

    def test_thread_local_stacks_are_independent(self):
        tracing.enable(capacity=100)
        seen = {}

        def worker():
            # No active span on this thread, even while the main thread
            # holds one.
            seen["current"] = tracing.current_span()
            with tracing.start_span("t2-root") as s:
                seen["trace"] = s.trace_id
                s.set_status("ok")

        with tracing.start_span("t1-root") as root:
            root.set_status("ok")
            t = threading.Thread(target=worker)
            t.start()
            t.join()
            assert seen["current"] is None
            assert seen["trace"] != root.trace_id

    def test_ring_buffer_bounded_and_counts_drops(self):
        tracing.enable(capacity=10)
        for i in range(25):
            s = tracing.start_span(f"s{i}", new_root=True, activate=False)
            s.set_status("ok")
            s.end()
        store = tracing.default_tracer().store
        assert len(store) == 10
        assert store.dropped == 15
        problems = tracing.audit_traces(store.traces(),
                                        dropped=store.dropped)
        assert any("dropped" in p for p in problems)

    def test_export_json_roundtrips(self):
        tracing.enable(capacity=10)
        with tracing.start_span("r") as s:
            s.set_attribute("k", "v")
            s.add_event("happened", {"n": 1})
            s.set_status("ok")
        doc = json.loads(tracing.default_tracer().store.export_json())
        assert doc["dropped"] == 0
        assert doc["spans"][0]["attributes"] == {"k": "v"}
        assert doc["spans"][0]["events"][0]["name"] == "happened"


class TestPropagation:
    def test_traceparent_roundtrip(self):
        ctx = tracing.SpanContext("ab" * 16, "cd" * 8)
        parsed = tracing.parse_traceparent(ctx.traceparent())
        assert (parsed.trace_id, parsed.span_id) == (ctx.trace_id,
                                                     ctx.span_id)

    @pytest.mark.parametrize("bad", [
        "", "garbage", "00-short-cdcdcdcdcdcdcdcd-01",
        "00-" + "zz" * 16 + "-" + "cd" * 8 + "-01",
        "00-" + "ab" * 16 + "-" + "cd" * 8,  # missing flags
    ])
    def test_malformed_traceparent_ignored(self, bad):
        assert tracing.parse_traceparent(bad) is None

    def test_inject_extract_via_annotations(self):
        tracing.enable(capacity=10)
        root = tracing.start_span("claim", activate=False)
        obj = {"metadata": {"name": "c1"}}
        tracing.inject(root, obj)
        key = tracing.TRACEPARENT_ANNOTATION
        assert key in obj["metadata"]["annotations"]
        ctx = tracing.extract(obj)
        assert ctx.trace_id == root.trace_id
        assert ctx.span_id == root.span_id
        root.set_status("ok")
        root.end()

    def test_span_for_object_prefers_active_then_annotation(self):
        tracing.enable(capacity=100)
        remote = tracing.start_span("remote-root", new_root=True,
                                    activate=False)
        obj = tracing.inject(remote, {"metadata": {"name": "c"}})
        # No active span → parents onto the annotation.
        with tracing.span_for_object("handler", obj) as h:
            assert h.trace_id == remote.trace_id
        # Active span wins over the annotation.
        with tracing.start_span("local-root") as local:
            with tracing.span_for_object("handler2", obj) as h2:
                assert h2.trace_id == local.trace_id
            local.set_status("ok")
        remote.set_status("ok")
        remote.end()

    def test_span_for_object_noop_without_context(self):
        tracing.enable(capacity=10)
        with tracing.span_for_object("h", {"metadata": {"name": "x"}}) as s:
            assert s is tracing.NOOP_SPAN
        assert len(tracing.default_tracer().store) == 0

    def test_propagation_across_thread(self):
        """The cross-thread stitch: a handler thread with no active span
        joins the trace through the object annotation."""
        tracing.enable(capacity=100)
        root = tracing.start_span("claim", activate=False)
        obj = tracing.inject(root, {"metadata": {"name": "c"}})

        def handler():
            with tracing.span_for_object("node_prepare", obj) as s:
                s.set_status("ok")

        t = threading.Thread(target=handler)
        t.start()
        t.join()
        root.set_status("ok")
        root.end()
        traces = tracing.default_tracer().store.traces()
        assert len(traces) == 1
        names = {s["name"] for s in next(iter(traces.values()))}
        assert names == {"claim", "node_prepare"}
        assert not tracing.audit_traces(traces)


class TestAuditAndBreakdown:
    def test_audit_flags_unended_root(self):
        tracing.enable(capacity=10)
        root = tracing.start_span("r", activate=False)
        with tracing.start_span("c", parent=root) as c:
            c.set_status("ok")
        # root never ended → not in store; its child is an orphan.
        problems = tracing.audit_traces(
            tracing.default_tracer().store.traces())
        assert any("orphaned" in p for p in problems)
        assert any("0 root spans" in p for p in problems)

    def test_audit_flags_unset_status(self):
        tracing.enable(capacity=10)
        root = tracing.start_span("r", activate=False)
        root.end()  # ended but status never set
        problems = tracing.audit_traces(
            tracing.default_tracer().store.traces())
        assert any("status 'unset'" in p for p in problems)

    def test_phase_breakdown_and_watch_delivery(self):
        tracing.enable(capacity=100)
        root = tracing.start_span("claim", activate=False)
        time.sleep(0.02)
        with tracing.start_span("node_prepare", parent=root) as np_span:
            np_span.set_status("ok")
        root.set_status("ok")
        root.end()
        bd = tracing.phase_breakdown(
            tracing.default_tracer().store.traces())
        assert set(bd) == {"node_prepare", "total", "watch_delivery"}
        assert bd["watch_delivery"]["p50_ms"] >= 15.0
        assert bd["total"]["count"] == 1

    def test_summarize_store(self):
        tracing.enable(capacity=100)
        with tracing.start_span("good") as g:
            g.set_status("ok")
        bad = tracing.start_span("bad", new_root=True, activate=False)
        bad.end()  # unset status
        rep = tracing.summarize_store(tracing.default_tracer().store)
        assert rep["traces"] == 2
        assert rep["complete"] == 1
        assert rep["audit_problem_count"] == 1


class TestFaultAnnotation:
    def test_injection_annotates_active_span(self):
        tracing.enable(capacity=10)
        with tracing.start_span("op") as span:
            with faultpoints.injected("cdi.write=nth:1"):
                with pytest.raises(faultpoints.InjectedFault):
                    faultpoints.maybe_fail("cdi.write")
            span.set_status("error", "injected")
        ev = span.events[0]
        assert ev["name"] == "fault.injected"
        assert ev["attributes"] == {"point": "cdi.write", "hit": 1,
                                    "action": "fail"}
        assert span.attributes["fault.injected"] is True

    def test_injection_without_tracing_unchanged(self):
        with faultpoints.injected("cdi.write=nth:1"):
            with pytest.raises(faultpoints.InjectedFault):
                faultpoints.maybe_fail("cdi.write")


# ---------------------------------------------------------------------------
# the logging formatters' trace ids
# ---------------------------------------------------------------------------

class TestLogging:
    def teardown_method(self, _m):
        root = stdlogging.getLogger()
        for h in list(root.handlers):
            if getattr(h, "_gpu_dra_logging", False):
                root.removeHandler(h)
        root.setLevel(stdlogging.WARNING)

    def test_json_lines_carry_component_and_trace(self):
        buf = io.StringIO()
        port_logging.setup_logging(component="gpu-kubelet-plugin",
                                   level="debug", fmt="json", stream=buf)
        tracing.enable(capacity=10)
        with tracing.start_span("op") as span:
            stdlogging.getLogger("x.y").info("hello %s", "world")
            span.set_status("ok")
        stdlogging.getLogger("x.y").info("after")
        lines = [json.loads(x) for x in buf.getvalue().splitlines()]
        assert lines[-2]["component"] == "gpu-kubelet-plugin"
        assert lines[-2]["message"] == "hello world"
        assert lines[-2]["trace_id"] == span.trace_id
        assert lines[-2]["span_id"] == span.span_id
        assert "trace_id" not in lines[-1]


# ---------------------------------------------------------------------------
# /debug/traces
# ---------------------------------------------------------------------------

class TestDebugEndpoints:
    def _get(self, port, path):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=5) as resp:
            return resp.status, json.loads(resp.read().decode())

    def test_traces_endpoint_serves_the_live_tracer(self):
        srv = MetricsServer(Registry(),
                            debug=standard_debug_handlers()).start()
        try:
            status, index = self._get(srv.port, "/debug")
            assert status == 200
            assert "/debug/traces" in index["endpoints"]
            _, traces = self._get(srv.port, "/debug/traces")
            assert traces["enabled"] is False
            assert traces["stored_spans"] == 0

            tracing.enable(capacity=16)
            with tracing.start_span("probe") as s:
                s.set_status("ok")
            _, traces = self._get(srv.port, "/debug/traces")
            assert traces["enabled"] is True
            assert traces["capacity"] == 16
            assert traces["stored_spans"] >= 1
            assert traces["spans"][-1]["trace_id"] == s.trace_id
        finally:
            srv.stop()

    def test_snapshot_is_bounded_newest_last(self):
        tracer = tracing.Tracer(capacity=500).enable()
        for i in range(300):
            sp = tracer.start_span(f"s{i}", new_root=True, activate=False)
            sp.set_status("ok")
            sp.end()
        snap = tracer.debug_snapshot(limit=200)
        assert snap["stored_spans"] == 300
        assert len(snap["spans"]) == 200
        assert snap["spans"][-1]["name"] == "s299"


# ---------------------------------------------------------------------------
# end-to-end: the full claim lifecycle in one trace + Events on failure
# ---------------------------------------------------------------------------

@pytest.fixture()
def stack(tmp_path):
    from k8s_dra_driver_tpu_torch.gpulib.device_lib import MockDeviceLib
    from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
    from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
        DriverConfig,
        GpuDriver,
    )

    client = FakeClient()
    _gpu_class(client)
    driver = GpuDriver(client, DriverConfig(
        node_name="n0", state_dir=str(tmp_path / "s"),
        cdi_root=str(tmp_path / "c"), env={}, retry_timeout=0.5,
    ), device_lib=MockDeviceLib("h100-8")).start()
    yield client, driver, Allocator(client)
    driver.stop()


class TestEndToEnd:
    def _traced_cycle(self, client, driver, alloc, name):
        from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef

        root = tracing.start_span("claim", attributes={"claim": name})
        obj = _claim_obj(name)
        tracing.inject(root, obj)
        claim = client.create(obj)
        claim = alloc.allocate(claim)
        uid = claim["metadata"]["uid"]
        res = driver.prepare_resource_claims([claim])[uid]
        root.set_status("ok" if res.error is None else "error")
        root.end()
        if res.error is None:
            driver.unprepare_resource_claims(
                [ClaimRef(uid=uid, name=name, namespace="default")])
        return res

    def test_one_trace_stitches_the_whole_lifecycle(self, stack):
        client, driver, alloc = stack
        tracing.enable(capacity=1000)
        res = self._traced_cycle(client, driver, alloc, "e2e")
        assert res.error is None
        traces = tracing.default_tracer().store.traces()
        assert len(traces) == 1
        spans = next(iter(traces.values()))
        names = [s["name"] for s in spans]
        assert names[0] == "claim"
        assert "allocate" in names
        assert "prepare" in names
        assert "checkpoint.transact" in names
        assert "cdi.write" in names
        assert not tracing.audit_traces(traces)
        bd = tracing.phase_breakdown(traces)
        assert {"allocate", "prepare", "checkpoint.transact",
                "cdi.write", "total"} <= set(bd)

    def test_injected_failure_trace_annotated_and_event_recorded(
            self, stack):
        client, driver, alloc = stack
        tracing.enable(capacity=1000)
        with faultpoints.injected("devicestate.prepare=first:100"):
            res = self._traced_cycle(client, driver, alloc, "doomed")
        assert res.error is not None
        assert faultpoints.is_injected(res.error)
        # The trace carries the injections inline...
        traces = tracing.default_tracer().store.traces()
        spans = next(iter(traces.values()))
        fault_events = [ev for s in spans for ev in s["events"]
                        if ev["name"] == "fault.injected"]
        assert fault_events
        assert fault_events[0]["attributes"]["point"] == "devicestate.prepare"
        assert not tracing.audit_traces(traces)
        # ...and the durable Event names the claim and the why.
        evs = events.list_events(client, involved_name="doomed",
                                 reason=events.REASON_PREPARE_FAILED)
        assert len(evs) == 1
        assert evs[0]["source"]["component"] == "gpu-kubelet-plugin"

    def test_controller_reconcile_joins_annotated_cd_trace(self):
        from k8s_dra_driver_tpu_torch.api.computedomain import (
            new_compute_domain,
        )
        from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.controller import (  # noqa: E501
            ComputeDomainController,
        )

        client = FakeClient()
        controller = ComputeDomainController(client)
        tracing.enable(capacity=100)
        root = tracing.start_span("cd-create", activate=False)
        cd_obj = new_compute_domain("traced", "default", num_nodes=1)
        tracing.inject(root, cd_obj)
        cd = client.create(cd_obj)
        controller.reconcile(cd)
        root.set_status("ok")
        root.end()
        traces = tracing.default_tracer().store.traces()
        spans = next(iter(traces.values()))
        assert any(s["name"] == "cd.reconcile" for s in spans)
        assert not tracing.audit_traces(traces)

    def test_trace_rides_an_incident_bundle(self, stack, tmp_path):
        """The flight recorder's trace section is the tracer's store: a
        traced claim's spans land in the bundle and on its timeline."""
        client, driver, alloc = stack
        tracing.enable(capacity=1000)
        self._traced_cycle(client, driver, alloc, "bundled")
        rec = blackbox.FlightRecorder(
            str(tmp_path / "rec"), client=client,
            tracer=tracing.default_tracer(),
            metrics=blackbox.BlackboxMetrics())
        rec.on_alert({"slo": "claim_ready", "severity": "page",
                      "transition": "fired"})
        doc = rec.bundle(rec.list_bundles()[0]["id"])
        names = {s["name"] for s in doc["sections"]["traces"]["spans"]}
        assert {"claim", "prepare", "cdi.write"} <= names
        assert doc["sections"]["traces"]["dropped"] == 0
        assert [e for e in doc["timeline"] if e["source"] == "span"]


# ---------------------------------------------------------------------------
# trace exemplars and prepare span events
# ---------------------------------------------------------------------------

class TestExemplars:
    def test_active_span_recorded_on_landing_bucket(self):
        tracing.enable(capacity=64)
        h = Histogram("gpu_dra_request_duration_seconds", "d",
                      (0.05, 0.1), ("operation",), exemplars=True)
        with tracing.start_span("op") as span:
            span.set_status("ok")
            h.observe(0.07, operation="prepare")
            trace_id = span.trace_id
        ex = h.exemplar("0.1", operation="prepare")
        assert ex is not None and ex[0] == trace_id and ex[1] == 0.07
        # Values past the last finite bound land on +Inf.
        with tracing.start_span("op2") as span:
            span.set_status("ok")
            h.observe(9.0, operation="prepare")
        assert h.exemplar("+Inf", operation="prepare") is not None

    def test_no_exemplar_without_span_or_when_disabled(self):
        h = Histogram("gpu_dra_request_duration_seconds", "d",
                      (0.05,), ("operation",), exemplars=True)
        h.observe(0.01, operation="prepare")   # tracing disabled
        assert h.exemplar("0.05", operation="prepare") is None
        h2 = Histogram("gpu_dra_x_seconds", "d", (0.05,), ("operation",))
        tracing.enable(capacity=8)
        with tracing.start_span("op") as s:
            s.set_status("ok")
            h2.observe(0.01, operation="prepare")
        assert not h2._exemplars

    def test_explicit_exemplar_wins_over_active_span(self):
        h = Histogram("gpu_dra_request_duration_seconds", "d",
                      (0.05,), (), exemplars=True)
        tracing.enable(capacity=8)
        with tracing.start_span("op") as s:
            s.set_status("ok")
            h.observe(0.01, exemplar="feedface")
        assert h.exemplar("0.05")[0] == "feedface"

    def test_exposition_round_trip_preserves_exemplars(self):
        tracing.enable(capacity=64)
        m = DRAMetrics()
        root = tracing.start_span("cycle")
        with m.timed_request(DRIVER, "prepare", trace_id=root.trace_id):
            pass
        root.set_status("ok")
        root.end()
        text = m.registry.expose_text()
        assert "# EXEMPLAR gpu_dra_request_duration_seconds_bucket" in text
        fams = parse_exposition(text)
        exs = [e for f in fams.values() for e in f.exemplars]
        assert len(exs) == 1 and exs[0].trace_id == root.trace_id
        rendered = render_exposition(fams.values())
        fams2 = parse_exposition(rendered)
        assert semantic_samples(fams) == semantic_samples(fams2)
        exs2 = [e for f in fams2.values() for e in f.exemplars]
        assert [(e.sample_name, e.labels, e.trace_id, e.value)
                for e in exs] == \
               [(e.sample_name, e.labels, e.trace_id, e.value)
                for e in exs2]
        rows = collect_exemplars({"node-0": fams})
        assert rows and rows[0]["trace_id"] == root.trace_id

    def test_malformed_exemplar_comment_is_ignored(self):
        fams = parse_exposition(
            "# TYPE gpu_dra_x counter\n"
            "# EXEMPLAR not a valid exemplar line\n"
            "# EXEMPLAR gpu_dra_x{le=\"0.1\"} value=nope\n"
            "gpu_dra_x 3\n")
        assert fams["gpu_dra_x"].exemplars == []
        assert fams["gpu_dra_x"].samples[0].value == 3.0


class TestPrepareSpanEvents:
    def test_prepare_phases_land_as_span_events(self, stack):
        from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef

        client, driver, alloc = stack
        tracing.enable(capacity=256)
        root = tracing.start_span("claim", new_root=True)
        claim = client.create(tracing.inject(root, _claim_obj("c1")))
        allocated = alloc.allocate(claim, node="n0")
        uid = allocated["metadata"]["uid"]
        res = driver.prepare_resource_claims([allocated])[uid]
        assert res.error is None
        driver.unprepare_resource_claims([ClaimRef(
            uid=uid, name="c1", namespace="default")])
        root.set_status("ok")
        root.end()
        traces = tracing.default_tracer().store.traces()
        spans = traces[root.trace_id]
        names = [s["name"] for s in spans]
        assert "driver_prepare" in names
        prep = next(s for s in spans if s["name"] == "prepare")
        ev_names = {e["name"] for e in prep["events"]}
        assert {"phase.serialize", "phase.core",
                "phase.cdi_spec"} <= ev_names
        # driver_prepare wraps prepare: parent chain intact.
        dp = next(s for s in spans if s["name"] == "driver_prepare")
        assert prep["parent_id"] == dp["span_id"]
        assert not tracing.audit_traces({root.trace_id: spans})


# ---------------------------------------------------------------------------
# held against the JAX package
# ---------------------------------------------------------------------------

_HEADERS = [
    "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "AB" * 16 + "-" + "CD" * 8 + "-00",
    "  00-" + "0f" * 16 + "-" + "e1" * 8 + "-01  ",
    "ff-" + "12" * 16 + "-" + "34" * 8 + "-zz",
    "", "garbage", "00-short-cdcdcdcdcdcdcdcd-01",
    "00-" + "zz" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "ab" * 16 + "-" + "cd" * 8,
    "00-" + "ab" * 16 + "-" + "cd" * 7 + "-01",
    "00-" + "ab" * 17 + "-" + "cd" * 8 + "-01",
    "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01-extra",
    "00--" + "cd" * 8 + "-01",
    "-".join(["00", "g" * 32, "h" * 16, "01"]),
]


def _span_dicts(seed):
    """Seeded trace sets with every shape the audit judges: complete
    traces, unended spans, unset and error roots, orphans, two roots, and
    node_prepare children that make the watch-delivery phase."""
    rng = random.Random(seed)
    traces = {}
    for t in range(rng.randrange(3, 9)):
        tid = f"{rng.getrandbits(128):032x}"
        t0 = 1000.0 + rng.random() * 10
        root = {"trace_id": tid, "span_id": f"{rng.getrandbits(64):016x}",
                "parent_id": "", "name": "claim", "start": t0,
                "end": t0 + rng.random() if rng.random() > 0.15 else 0.0,
                "status": rng.choice(["ok", "ok", "ok", "error", "unset"]),
                "events": []}
        spans = [root]
        if rng.random() < 0.1:
            spans.append(dict(root, span_id=f"{rng.getrandbits(64):016x}"))
        for k in range(rng.randrange(0, 6)):
            parent = rng.choice(spans)["span_id"]
            if rng.random() < 0.1:
                parent = "0" * 16
            st = t0 + rng.random() * 0.01
            spans.append({
                "trace_id": tid, "span_id": f"{rng.getrandbits(64):016x}",
                "parent_id": parent,
                "name": rng.choice(["node_prepare", "prepare", "cdi.write",
                                    "checkpoint.transact", "allocate"]),
                "start": st,
                "end": st + rng.random() * 0.01 if rng.random() > 0.1
                else 0.0,
                "status": "ok",
                "events": ([{"name": "fault.injected", "time": st,
                             "attributes": {}}]
                           if rng.random() < 0.1 else [])})
        traces[tid] = spans
    return traces


class _Store:
    """The store surface ``summarize_store`` reads, over fixed dicts."""

    def __init__(self, traces, dropped, appended):
        self._traces = traces
        self.dropped = dropped
        self.appended = appended

    def traces(self):
        return self._traces


class TestAgainstJax:
    @pytest.mark.parametrize("header", _HEADERS)
    def test_traceparent_codec_agrees(self, header):
        port, ref = (tracing.parse_traceparent(header),
                     jax_tracing.parse_traceparent(header))
        assert (port is None) == (ref is None)
        if port is not None:
            assert (port.trace_id, port.span_id) == \
                (ref.trace_id, ref.span_id)
            assert tracing.format_traceparent(port) == \
                jax_tracing.format_traceparent(ref)

    def test_annotation_key_and_defaults_are_jaxs(self):
        assert tracing.TRACEPARENT_ANNOTATION == \
            jax_tracing.TRACEPARENT_ANNOTATION
        assert tracing.DEFAULT_CAPACITY == jax_tracing.DEFAULT_CAPACITY
        assert tracing.debug_snapshot() == jax_tracing.Tracer().debug_snapshot()

    @pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
    def test_a_stamped_claim_crosses_packages(self, direction):
        port_t = tracing.Tracer().enable()
        jax_t = jax_tracing.Tracer().enable()
        stamp, read = ((jax_t, port_t) if direction == "jax_to_port"
                       else (port_t, jax_t))
        root = stamp.start_span("claim", activate=False)
        obj = stamp.inject(root, {"metadata": {"name": "c"}})
        ctx = read.extract(json.loads(json.dumps(obj)))
        assert (ctx.trace_id, ctx.span_id) == (root.trace_id, root.span_id)
        child = read.start_span("node_prepare", parent=ctx, activate=False)
        assert child.trace_id == root.trace_id
        assert child.parent_id == root.span_id

    @pytest.mark.parametrize("seed", range(8))
    def test_audit_breakdown_and_summary_agree(self, seed):
        traces = _span_dicts(seed)
        dropped = seed % 3
        assert tracing.audit_traces(traces, dropped=dropped) == \
            jax_tracing.audit_traces(traces, dropped=dropped)
        assert tracing.phase_breakdown(traces) == \
            jax_tracing.phase_breakdown(traces)
        n = sum(len(v) for v in traces.values())
        for started in (None, n, n + 2):
            assert tracing.summarize_store(
                _Store(traces, dropped, n), started=started) == \
                jax_tracing.summarize_store(
                    _Store(traces, dropped, n), started=started)
        assert list(tracing.iter_roots(traces)) == \
            list(jax_tracing.iter_roots(traces))

    def test_plugin_process_serves_a_complete_claim_trace(self, tmp_path):
        """The GPU plugin as a process with ``--trace true``: a claim
        stamped here and created and allocated over HTTP is prepared by
        the process, whose ``/debug/traces`` holds the claim's spans;
        merged with the root they make one complete trace, and the
        prepare histogram's exemplar names it."""
        from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator

        server = ApiServer().start()
        client = HttpClient(server.endpoint)
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("GPU_DRA_")}
        env["PYTHONPATH"] = REPO
        log = open(tmp_path / "plugin.log", "w+")
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin",
             "--node-name", "node-0", "--api-endpoint", server.endpoint,
             "--mock-profile", "h100-8", "--state-dir",
             str(tmp_path / "state"), "--cdi-root", str(tmp_path / "cdi"),
             "--metrics-port", "0", "--healthcheck-addr", "",
             "--trace", "true"],
            stdout=log, stderr=subprocess.STDOUT, cwd=REPO, env=env)
        try:
            def logged(pattern):
                log.seek(0)
                m = re.search(pattern, log.read())
                return m.group(1) if m else None

            _gpu_class(client)
            client.create(new_object("Node", "node-0"))
            assert _until(lambda: logged(r"(running on node node-0)"),
                          timeout=60), logged("(.*)")
            base = "http://127.0.0.1:" + logged(
                r"metrics on http://127\.0\.0\.1:(\d+)/metrics")
            tracer = tracing.Tracer().enable()
            root = tracer.start_span("claim", new_root=True, activate=False)
            claim = client.create(tracer.inject(root, _claim_obj("c1")))
            Allocator(client).allocate(claim, reserved_for=[
                {"resource": "pods", "name": "p"}], node="node-0")

            def ready():
                c = client.get("ResourceClaim", "c1", "default")
                return any(k.get("type") == "Ready"
                           for d in (c.get("status") or {}).get(
                               "devices") or []
                           for k in d.get("conditions") or [])

            assert _until(ready)
            root.set_status("ok")
            root.end()

            def remote():
                with urllib.request.urlopen(base + "/debug/traces") as r:
                    snap = json.loads(r.read())
                assert snap["enabled"] is True
                return [s for s in snap["spans"]
                        if s["trace_id"] == root.trace_id]

            assert _until(lambda: {"node_prepare", "cdi.write"} <= {
                s["name"] for s in remote()})
            merged = {root.trace_id: [root.to_dict(), *remote()]}
            assert tracing.audit_traces(merged) == []
            assert jax_tracing.audit_traces(merged) == []
            names = {s["name"] for s in merged[root.trace_id]}
            assert {"node_prepare", "driver_prepare", "prepare",
                    "checkpoint.transact", "cdi.write"} <= names
            assert {"watch_delivery", "node_prepare", "total"} <= set(
                tracing.phase_breakdown(merged))
            with urllib.request.urlopen(base + "/metrics") as r:
                text = r.read().decode()
            assert re.search(
                r"# EXEMPLAR gpu_dra_request_duration_seconds_bucket\{"
                r'driver="gpu\.nvidia\.com",operation="prepare",[^}]*\} '
                rf"trace_id={root.trace_id} ", text), text
            proc.terminate()
            assert proc.wait(timeout=30) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
            log.close()
            server.stop()
