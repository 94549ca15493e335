"""The flight recorder's retention against an incident that resolves late.

Under CPU load the incident leg of the node-kill soak
(``tests/test_torch_blackbox.py::TestIncidentLeg``) sees the
``prepare_errors`` page fire and clear many times while its ticket stays
open. The ticket's incident has an early, sequence-prefixed id; when it
resolves, its bundle is rewritten last. Retention that orders bundles by
id evicts that newest write at once, while the index still lists it as
the newest resolved bundle, so ``/debug/incidents`` served ``latest:
null`` and the leg's HTTP oracle found no complete bundle
(``python -m k8s_dra_driver_tpu_torch.internal.soakload --runs 8 --hogs 12
--rounds 12``: 8 of 96 runs). The port's recorder keeps the newest
bundles by capture and drops evicted ones from its index; the JAX
package's recorder keeps the fault (pinned last).
"""

from __future__ import annotations

import json
import os
import urllib.request

from k8s_dra_driver_tpu_torch.internal.common import standard_debug_handlers
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.pkg import slo as slolib
from k8s_dra_driver_tpu_torch.pkg.blackbox import (
    BlackboxMetrics,
    FlightRecorder,
)
from k8s_dra_driver_tpu_torch.pkg.metrics import MetricsServer, Registry


def _transition(slo, severity, transition, at, sl=slolib):
    return sl.AlertTransition(
        slo=slo, severity=severity, transition=transition,
        burn_short=20.0 if transition == "fired" else 0.1,
        burn_long=16.0 if transition == "fired" else 2.0, threshold=14.4,
        at=at)


def _flapping_pages_under_an_open_ticket(rec, pages, sl=slolib):
    """The soak's sequence: the ticket fires first and stays open while the
    page fires and clears ``pages`` times, then the ticket clears. Returns
    the ticket's incident id."""
    rec.on_alert(_transition("prepare_errors", "ticket", "fired", 1.0, sl))
    ticket = rec.list_bundles()[0]["id"]
    for i in range(pages):
        rec.on_alert(_transition("prepare_errors", "page", "fired",
                                 2.0 + i, sl))
        rec.on_alert(_transition("prepare_errors", "page", "cleared",
                                 2.5 + i, sl))
    rec.on_alert(_transition("prepare_errors", "ticket", "cleared",
                             3.0 + pages, sl))
    return ticket


def test_a_late_resolved_incident_survives_retention(tmp_path):
    m = BlackboxMetrics()
    rec = FlightRecorder(str(tmp_path), client=FakeClient(), retention=2,
                         metrics=m)
    ticket = _flapping_pages_under_an_open_ticket(rec, pages=2)
    # The newest two captures: the ticket resolved, then the second page
    # resolved before it. The ticket's open bundle went when the second
    # page opened (three captures), the first page's when the ticket
    # resolved; each eviction is counted, and evicted bundles leave the
    # index.
    newest = rec.list_bundles()
    assert [b["id"] for b in newest][0] == ticket
    assert [b["status"] for b in newest] == ["resolved", "resolved"]
    assert sorted(f[:-len(".json")] for f in os.listdir(rec.dir)) == \
        sorted(b["id"] for b in newest)
    assert rec.evicted == 2 and m.bundles_evicted_total.value() == 2
    doc = rec.bundle(ticket)
    assert doc is not None and doc["status"] == "resolved"
    latest = rec.debug_snapshot()["latest"]
    assert latest is not None and latest["id"] == ticket
    assert latest["status"] == "resolved"


def test_every_listed_bundle_is_served_over_http(tmp_path):
    # The soak's retention (8) and a page that flaps nine times under the
    # open ticket: every bundle the index lists can be read, and
    # /debug/incidents serves the ticket's resolved bundle in full.
    rec = FlightRecorder(str(tmp_path), client=FakeClient(), retention=8,
                         metrics=BlackboxMetrics())
    ticket = _flapping_pages_under_an_open_ticket(rec, pages=9)
    listed = rec.list_bundles()
    assert len(listed) == 8 and len(os.listdir(rec.dir)) == 8
    assert all(rec.bundle(b["id"]) is not None for b in listed)
    srv = MetricsServer(Registry(), port=0,
                        debug=standard_debug_handlers()).start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/debug/incidents",
                timeout=5.0) as resp:
            served = json.loads(resp.read().decode())
    finally:
        srv.stop()
    (mine,) = [r for r in served if r.get("dir") == rec.dir]
    assert mine["latest"] is not None
    assert (mine["latest"]["id"], mine["latest"]["status"]) == (
        ticket, "resolved")
    assert [b["id"] for b in mine["bundles"]] == [b["id"] for b in listed]


def test_jax_recorder_evicts_the_bundle_it_just_resolved(tmp_path):
    """The JAX package's recorder, which stays as it is, orders retention
    by id: the late-resolved ticket's bundle is deleted as it is written,
    its index still lists it, and its debug snapshot serves no bundle."""
    from k8s_dra_driver_tpu.k8sclient import FakeClient as JaxFakeClient
    from k8s_dra_driver_tpu.pkg import blackbox as jbb, slo as jslo
    rec = jbb.FlightRecorder(str(tmp_path), client=JaxFakeClient(),
                             retention=2, metrics=jbb.BlackboxMetrics())
    ticket = _flapping_pages_under_an_open_ticket(rec, pages=2, sl=jslo)
    assert rec.list_bundles()[0]["id"] == ticket
    assert rec.bundle(ticket) is None
    assert rec.debug_snapshot()["latest"] is None
