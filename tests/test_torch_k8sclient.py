"""The port's fake API server and informer behave as the JAX package's.

The same sequence of verbs goes through a JAX ``FakeClient`` and a port
``FakeClient``; the two must return the same objects (up to uids and
timestamps), raise the same errors, and deliver the same watch events,
including a watch resumed from the resourceVersion a LIST was read at.
The port's informer resumes a dropped watch without a relist and relists
when the resume point has left the backlog.
"""

import time

import pytest

from k8s_dra_driver_tpu.k8sclient import client as jax_client
from k8s_dra_driver_tpu_torch.k8sclient import Informer
from k8s_dra_driver_tpu_torch.k8sclient import client as port_client
from k8s_dra_driver_tpu_torch.pkg import faultpoints

CLIENTS = (jax_client, port_client)


def _view(obj):
    """An object without the fields that differ by run (uid, times)."""
    m = obj["metadata"]
    return {"kind": obj["kind"], "name": m["name"],
            "namespace": m.get("namespace", ""),
            "labels": m.get("labels"), "finalizers": m.get("finalizers"),
            "terminating": m.get("deletionTimestamp") is not None,
            "spec": obj.get("spec"), "status": obj.get("status")}


def _drain(w, n):
    out = []
    while len(out) < n:
        ev = w.next(timeout=5.0)
        assert ev is not None, f"only {len(out)} of {n} events arrived"
        if ev.type != "BOOKMARK":
            out.append((ev.type, _view(ev.object)))
    return out


def _script(mod):
    """Drive one client through CRUD, status, finalizers and a resumed
    watch; returns every observable result in order."""
    c = mod.FakeClient()
    seen = []
    for i in range(3):
        c.create(mod.new_object("ResourceClaim", f"c{i}", "default",
                                spec={"n": i}, metadata={
                                    "name": f"c{i}", "namespace": "default",
                                    "labels": {"i": str(i % 2)}}))
    items, rv = _list_rv(c, "ResourceClaim", "default")
    seen.append([_view(o) for o in items])
    seen.append([_view(o) for o in c.list("ResourceClaim",
                                          label_selector={"i": "0"})])
    with pytest.raises(mod.AlreadyExistsError):
        c.create(mod.new_object("ResourceClaim", "c0", "default"))
    obj = c.get("ResourceClaim", "c0", "default")
    obj["status"] = {"allocation": {"n": 1}}
    obj["spec"] = {"n": 99}  # update_status takes only the status
    seen.append(_view(c.update_status(obj)))
    with pytest.raises(mod.ConflictError):
        c.update(obj)  # its resourceVersion is stale now
    c.add_finalizer("ResourceClaim", "c1", "gpu.nvidia.com/x", "default")
    c.delete("ResourceClaim", "c1", "default")
    seen.append(_view(c.get("ResourceClaim", "c1", "default")))
    c.remove_finalizer("ResourceClaim", "c1", "gpu.nvidia.com/x", "default")
    assert c.try_get("ResourceClaim", "c1", "default") is None
    c.delete("ResourceClaim", "c2", "default")
    with pytest.raises(mod.NotFoundError):
        c.get("ResourceClaim", "c2", "default")
    # A watch resumed at the LIST's rv replays exactly what came after.
    w = c.watch("ResourceClaim", "default", resource_version=rv)
    seen.append(_drain(w, 5))
    w.stop()
    return seen


def _list_rv(c, kind, namespace):
    """(items, rv) from either package's client."""
    page = c.list_page(kind, namespace)
    return page["items"], int(page["metadata"]["resourceVersion"])


def test_same_verbs_same_results():
    jax_seen, port_seen = (_script(m) for m in CLIENTS)
    assert port_seen == jax_seen
    events = [t for t, _ in port_seen[-1]]
    assert events == ["MODIFIED", "MODIFIED", "MODIFIED", "DELETED",
                      "DELETED"]


@pytest.mark.parametrize("mod", CLIENTS, ids=("jax", "port"))
def test_resume_past_backlog_expires(mod):
    c = mod.FakeClient()
    c.create(mod.new_object("Node", "n0"))
    for i in range(mod.DEFAULT_BACKLOG_WINDOW + 1):
        o = c.get("Node", "n0")
        o.setdefault("metadata", {})["labels"] = {"i": str(i)}
        c.update(o)
    with pytest.raises(mod.ExpiredError):
        c.watch("Node", resource_version=1)


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition not met in time"
        time.sleep(0.005)


def test_informer_resumes_then_relists():
    c = port_client.FakeClient()
    c.create(port_client.new_object("Node", "n0"))
    inf = Informer(c, "Node").start()
    try:
        assert inf.wait_for_cache_sync(5.0)
        assert [o["metadata"]["name"] for o in inf.cached_list()] == ["n0"]
        # A dropped stream resumes from the newest rv seen: no relist.
        with faultpoints.injected("k8sclient.watch.drop=first:1"):
            _wait(lambda: inf.resume_count >= 1)
        c.create(port_client.new_object("Node", "n1"))
        _wait(lambda: len(inf.cached_list()) == 2)
        assert inf.relist_count == 0
    finally:
        inf.stop()
    # A resume point that has left the backlog falls back to a relist.
    for i in range(port_client.DEFAULT_BACKLOG_WINDOW + 1):
        o = c.get("Node", "n0")
        o["metadata"]["labels"] = {"i": str(i)}
        c.update(o)
    late = Informer(c, "Node", resume_rv=1).start()
    try:
        assert late.wait_for_cache_sync(5.0)
        assert late.relist_count == 1 and not late.resumed_from_checkpoint
        assert sorted(o["metadata"]["name"]
                      for o in late.cached_list()) == ["n0", "n1"]
    finally:
        late.stop()


def test_a_dropped_watch_hands_out_nothing_after_the_drop():
    """A fan-out that captured its watcher list before the drop can still
    aim a newer event at the dead watch. Handed out, that event would move
    the consumer's resume point past the events the drop discarded, and
    the resume would never replay them (the node fleet's claim that never
    turned Ready). So a dropped watch yields nothing more, and the resume
    from the last event consumed replays every discarded one."""
    c = port_client.FakeClient()
    w = c.watch("ConfigMap", "default")
    for name in ("a", "b"):
        c.create(port_client.new_object("ConfigMap", name, "default"))
    first = w.next(timeout=1.0)
    assert first.object["metadata"]["name"] == "a"
    with faultpoints.injected("k8sclient.watch.drop=first:1"):
        assert w.next(timeout=0.05) is None          # "b" discarded
    assert not w.alive
    late = port_client.new_object("ConfigMap", "late", "default")
    late["metadata"]["resourceVersion"] = "99"
    assert not w.deliver(port_client.WatchEvent("ADDED", late))
    w.events.put(port_client.WatchEvent("ADDED", late))   # queued anyway
    assert w.next(timeout=0.05) is None
    resumed = c.watch("ConfigMap", "default", resource_version=int(
        first.object["metadata"]["resourceVersion"]))
    assert [resumed.next(timeout=1.0).object["metadata"]["name"]] == ["b"]
    resumed.stop()
