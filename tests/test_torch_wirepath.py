"""The port's HTTP API substrate, held against the JAX package's.

The wire codec encodes the corpus of ``tests/test_wirepath.py::
TestWirecodecDifferential`` to the same bytes as the JAX codec (and as
``json.dumps``). Then each package's ``HttpClient`` runs against the other
package's ``ApiServer`` (and the port's against its own), over CRUD and the
error mapping (404/409/410), label-selected and paginated LISTs with
``continue`` tokens, a watch resumed from a resourceVersion and refused with
410 when too old, bookmarks and ``send_initial`` ordering: every pairing
gives the transcript of JAX's client against JAX's server. The port's
``Informer`` lists (in pages) and watches over ``HttpClient``, on either
server. Then the port's status writes, its watch-queue bound and its
keep-alive client.
"""

import functools
import json
import random
import threading
import time

import pytest

from k8s_dra_driver_tpu.k8sclient import client as jax_client
from k8s_dra_driver_tpu.k8sclient import httpapi as jax_httpapi
from k8s_dra_driver_tpu.k8sclient import wirecodec as jax_wirecodec
from k8s_dra_driver_tpu_torch.k8sclient import Informer
from k8s_dra_driver_tpu_torch.k8sclient import client as port_client
from k8s_dra_driver_tpu_torch.k8sclient import httpapi as port_httpapi
from k8s_dra_driver_tpu_torch.k8sclient import informer as port_informer
from k8s_dra_driver_tpu_torch.k8sclient import wirecodec
from k8s_dra_driver_tpu_torch.pkg import faultpoints

new_object = port_client.new_object

#: package name → (client module, httpapi module)
PACKAGES = {"jax": (jax_client, jax_httpapi),
            "port": (port_client, port_httpapi)}
#: (client package, server package) pairings held against JAX/JAX.
PAIRS = [("port", "jax"), ("jax", "port"), ("port", "port")]
PAIR_IDS = [f"{c}-client-{s}-server" for c, s in PAIRS]


# -- the codec: the JAX differential corpus, byte for byte ------------------

def _random_json(rng: random.Random, depth: int = 0):
    """``tests/test_wirepath.py``'s generator of JSON-shaped values."""
    roll = rng.random()
    if depth >= 4 or roll < 0.35:
        return rng.choice([
            None, True, False, 0, -1, 17, 2**53, -2**40,
            0.0, -0.0, 1.5, 3.141592653589793, 1e300, -2.5e-10,
            "", "name", "α/β✓", "line\nbreak", "tab\tquote\"back\\slash",
            "\x00\x1f control", "🙂 emoji", "ascii only",
            "annotation.tpu.google.com/slice",
        ])
    if roll < 0.7:
        return {rng.choice(["kind", "metadata", "spec", "status", "名前",
                            "a/b", "x" * rng.randint(1, 9)]):
                _random_json(rng, depth + 1)
                for _ in range(rng.randint(0, 4))}
    return [_random_json(rng, depth + 1) for _ in range(rng.randint(0, 4))]


def _fuzz_docs(seed, n):
    rng = random.Random(seed)
    return [_random_json(rng) for _ in range(n)]


class _E(int):
    """A scalar subclass: outside the fast path's exact types."""


def _deep():
    doc = leaf = {}
    for _ in range(200):
        leaf["d"] = {}
        leaf = leaf["d"]
    return doc


#: name → (documents, whether the fast path takes them)
CODEC_CORPUS = {
    "fuzz-seed-7": (_fuzz_docs(7, 300), True),
    "float-specials": ([[float("nan")], [float("inf")], [float("-inf")]],
                       True),
    "non-str-key": ([{1: "int-keyed"}], False),
    "scalar-subclass": ([{"v": _E(1)}], False),
    "deep-nesting": ([_deep()], False),
}


@pytest.mark.parametrize("case", sorted(CODEC_CORPUS))
def test_encode_obj_is_jax_bytes(case):
    docs, fast = CODEC_CORPUS[case]
    wirecodec.reset_fallback_counts()
    for doc in docs:
        got = wirecodec.encode_obj(doc)
        assert got == jax_wirecodec.encode_obj(doc)
        assert got == json.dumps(doc).encode()
    assert (wirecodec.fallback_counts() == {}) == fast


def test_watch_frames_and_list_pages_are_jax_bytes():
    rng = random.Random(11)
    for _ in range(50):
        obj = {"kind": "Pod", "metadata": {"name": "p"},
               "spec": _random_json(rng)}
        ob = wirecodec.encode_obj(obj)
        assert wirecodec.wire_watch_frame("MODIFIED", ob) == \
            jax_wirecodec.wire_watch_frame("MODIFIED", ob)
    rng = random.Random(13)
    items = [wirecodec.encode_obj({"kind": "X", "metadata": {
        "name": f"n{i}"}, "data": _random_json(rng)}) for i in range(5)]
    assert wirecodec.wire_list_page(items, "42", "tok") == \
        jax_wirecodec.wire_list_page(items, "42", "tok")
    assert wirecodec._self_check() is None


def test_unencodable_raises_like_jax_and_counts():
    wirecodec.reset_fallback_counts()
    with pytest.raises(TypeError):
        wirecodec.encode_doc({"v": object()})
    with pytest.raises(TypeError):
        jax_wirecodec.encode_doc({"v": object()})
    assert wirecodec.fallback_counts() == {"encode_doc": 1}
    wirecodec.encode_obj({2: "x"})
    assert wirecodec.fallback_counts() == {"encode_doc": 1, "encode_obj": 1}


def test_watch_event_wire_is_the_frame_jax_sends():
    for mod in (port_client, jax_client):
        c = mod.FakeClient()
        w = c.watch("Pod")
        c.create(new_object("Pod", "p", labels={"α": "β"}))
        ev = w.next(1.0)
        assert ev.wire() == (json.dumps(
            {"type": "ADDED", "object": ev.object}) + "\n").encode()
        w.stop()


# -- each client against each server ----------------------------------------

#: writes that push any resourceVersion out of both packages' backlogs.
PAST_BACKLOG = max(jax_client.DEFAULT_BACKLOG_WINDOW,
                   port_client.DEFAULT_BACKLOG_WINDOW) + 8


def _serve(server_pkg):
    cmod, hmod = PACKAGES[server_pkg]
    return hmod.ApiServer(cmod.FakeClient()).start()


def _churn(store):
    """Commits PAST_BACKLOG ConfigMap writes straight to the server's
    store (in process: over HTTP they would take seconds), so that every
    older resourceVersion of the kind falls out of its backlog."""
    obj = (store.try_get("ConfigMap", "churn", "churn")
           or store.create(new_object("ConfigMap", "churn", "churn")))
    for i in range(PAST_BACKLOG):
        obj["data"] = {"i": str(i)}
        obj = store.update(obj)


def _client(client_pkg, server):
    return PACKAGES[client_pkg][1].HttpClient(server.endpoint)


def _err(fn):
    """The name of the error ``fn`` raises (None when it returns)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the name is the result
        return type(e).__name__
    return None


def _crud(c, churn):
    t = []
    obj = c.create(new_object("ConfigMap", "cm", "default", data={"a": "1"}))
    t.append(("create", obj["metadata"]["name"],
              obj["metadata"]["resourceVersion"], bool(obj["metadata"]["uid"])))
    got = c.get("ConfigMap", "cm", "default")
    got["data"]["b"] = "2"
    t.append(("update", c.update(got)["metadata"]["resourceVersion"]))
    t.append(("get", c.get("ConfigMap", "cm", "default")["data"]))
    t.append(("missing", _err(lambda: c.get("ConfigMap", "nope", "default"))))
    c.create(new_object("ConfigMap", "dup", "default"))
    t.append(("dup", _err(lambda: c.create(
        new_object("ConfigMap", "dup", "default")))))
    stale = c.get("ConfigMap", "dup", "default")
    c.update(dict(stale))
    t.append(("stale", _err(lambda: c.update(stale))))
    c.create(new_object("Widget", "w", "default", spec={"x": 1}))
    w = c.get("Widget", "w", "default")
    w["status"], w["spec"] = {"ready": True}, {"x": 999}
    c.update_status(w)
    got = c.get("Widget", "w", "default")
    t.append(("status", got["status"], got["spec"]))
    c.create(new_object("Thing", "t", "default"))
    c.add_finalizer("Thing", "t", "keep", "default")
    c.delete("Thing", "t", "default")
    t.append(("finalized", c.get("Thing", "t", "default")["metadata"][
        "deletionTimestamp"] is not None))
    c.remove_finalizer("Thing", "t", "keep", "default")
    t.append(("gone", c.try_get("Thing", "t", "default")))
    c.delete("ConfigMap", "cm", "default")
    t.append(("deleted", c.try_get("ConfigMap", "cm", "default"),
              _err(lambda: c.delete("ConfigMap", "cm", "default"))))
    return t


def _lists(c, churn):
    t = []
    for i, zone in enumerate("abab"):
        n = new_object("Node", f"n{i}")
        n["metadata"]["labels"] = {"zone": zone}
        c.create(n)
    t.append(("selected", [n["metadata"]["name"] for n in c.list(
        "Node", label_selector={"zone": "a"})]))
    for i in range(12):
        c.create(new_object("ConfigMap", f"cm{i:02d}", "default"))
    c.create(new_object("ConfigMap", "other-ns", "elsewhere"))
    names, token, pages = [], "", []
    while True:
        page = c.list_page("ConfigMap", "default", limit=5,
                           continue_token=token)
        names += [o["metadata"]["name"] for o in page["items"]]
        pages.append((len(page["items"]), page["metadata"]["resourceVersion"]))
        token = page["metadata"]["continue"]
        if not token:
            break
    t.append(("pages", pages, names))
    t.append(("all", len(c.list("ConfigMap")),
              len(c.list("ConfigMap", "default"))))
    return t


def _watches(c, churn):
    t = []
    first = c.create(new_object("ConfigMap", "a", "default"))
    c.create(new_object("ConfigMap", "b", "default"))
    c.delete("ConfigMap", "a", "default")
    w = c.watch("ConfigMap", resource_version=int(
        first["metadata"]["resourceVersion"]))
    got = []
    for _ in range(2):
        ev = w.next(timeout=5.0)
        got.append((ev.type, ev.object["metadata"]["name"],
                    ev.object["metadata"]["resourceVersion"]))
    w.stop()
    t.append(("resumed", got))
    live = c.watch("ConfigMap", "default")
    c.create(new_object("ConfigMap", "c", "default"))
    ev = live.next(timeout=5.0)
    t.append(("live", ev.type, ev.object["metadata"]["name"]))
    live.stop()
    for i in range(6):
        c.create(new_object("ConfigMap", f"x{i}", "default"))
    churn()
    t.append(("too-old", _err(lambda: c.watch("ConfigMap",
                                                resource_version=1))))
    page = c.list_page("ConfigMap", "default", limit=2)
    churn()
    t.append(("expired-continue", _err(lambda: c.list_page(
        "ConfigMap", "default", limit=2,
        continue_token=page["metadata"]["continue"]))))
    return t


def _initial_and_bookmarks(c, churn):
    t = []
    for i in range(5):
        c.create(new_object("ConfigMap", f"pre{i}", "default"))
    w = c.watch("ConfigMap", send_initial=True)
    c.create(new_object("ConfigMap", "live", "default"))
    names = []
    for _ in range(6):
        ev = w.next(timeout=5.0)
        names.append((ev.type, ev.object["metadata"]["name"]))
    w.stop()
    t.append(("initial-then-live", names))
    t.append(("both", _err(lambda: c.watch(
        "ConfigMap", send_initial=True, resource_version=1))))
    b = c.watch("ConfigMap", namespace="elsewhere", bookmark_interval=0.1)
    for i in range(3):
        c.create(new_object("ConfigMap", f"c{i}", "default"))
    ev, deadline = None, time.time() + 10
    while ev is None and time.time() < deadline:
        ev = b.next(timeout=0.5)
    b.stop()
    t.append(("bookmark", ev.type,
              int(ev.object["metadata"]["resourceVersion"]) >= 6))
    return t


def _transcript(scenario, client_pkg, server_pkg):
    server = _serve(server_pkg)
    try:
        return scenario(_client(client_pkg, server),
                        lambda: _churn(server.client))
    finally:
        server.stop()


#: Each scenario returns a transcript; errors appear by class name (the
#: port's error classes carry the JAX package's names).
SCENARIOS = {"crud": _crud, "lists": _lists, "watches": _watches,
             "initial-and-bookmarks": _initial_and_bookmarks}


@functools.lru_cache(maxsize=None)
def _jax_transcript(scenario):
    """JAX's client against JAX's server: the reference, run once."""
    return _transcript(SCENARIOS[scenario], "jax", "jax")


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_client_against_server_gives_jax_transcript(scenario, pair):
    want = _jax_transcript(scenario)
    got = _transcript(SCENARIOS[scenario], *pair)
    assert got == want


def test_transcripts_cover_every_status():
    """The error mapping the pairings are held to: 404, 409 (both
    reasons), 410 (watch and continue token) and the send_initial
    refusal (400)."""
    crud = dict((r[0], r[1:]) for r in _transcript(_crud, "port", "port"))
    assert crud["missing"] == ("NotFoundError",)
    assert crud["dup"] == ("AlreadyExistsError",)
    assert crud["stale"] == ("ConflictError",)
    watches = dict((r[0], r[1:]) for r in _transcript(
        _watches, "port", "jax"))
    assert watches["too-old"] == ("ExpiredError",)
    assert watches["expired-continue"] == ("ExpiredError",)
    init = dict((r[0], r[1:]) for r in _transcript(
        _initial_and_bookmarks, "jax", "port"))
    assert init["both"] == ("HTTPError",)


def test_status_429_maps_to_too_many_requests():
    """An injected 429 Status from the port's server reaches each client
    as its TooManyRequestsError, marked injected."""
    server = _serve("port")
    try:
        with faultpoints.injected(
                "k8sclient.apiserver.response=nth:1:toomany"):
            with pytest.raises(jax_httpapi.TooManyRequestsError) as e:
                _client("jax", server).get("ConfigMap", "x", "default")
        assert getattr(e.value, "_tpu_dra_injected", False)
        with faultpoints.injected(
                "k8sclient.apiserver.response=nth:1:toomany"):
            with pytest.raises(port_httpapi.TooManyRequestsError) as e:
                _client("port", server).get("ConfigMap", "x", "default")
        assert faultpoints.is_injected(e.value)
    finally:
        server.stop()


# -- the port's informer over HTTP (its paginated relist) -------------------

def _wait(cond, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline and not cond():
        time.sleep(0.02)
    return cond()


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_informer_lists_in_pages_and_watches_over_http(server_pkg,
                                                       monkeypatch):
    monkeypatch.setattr(port_informer, "LIST_PAGE_LIMIT", 2)
    server = _serve(server_pkg)
    client = port_httpapi.HttpClient(server.endpoint)
    for i in range(5):
        client.create(new_object("Pod", f"p{i}", "default"))
    calls = []
    lister = client.list_page

    def counted(*a, **kw):
        calls.append(kw.get("limit"))
        return lister(*a, **kw)

    client.list_page = counted
    adds, dels = [], []
    inf = Informer(client, "Pod",
                   on_add=lambda o: adds.append(o["metadata"]["name"]),
                   on_delete=lambda o: dels.append(o["metadata"]["name"]))
    inf.start()
    try:
        inf.wait_for_cache_sync()
        assert calls == [2, 2, 2]          # 5 objects in pages of 2
        assert sorted(adds) == [f"p{i}" for i in range(5)]
        client.create(new_object("Pod", "live", "default"))
        client.delete("Pod", "p0", "default")
        assert _wait(lambda: "live" in adds and dels == ["p0"])
        assert inf.relist_count == 0
    finally:
        inf.stop()
        server.stop()


def test_informer_relists_after_apiserver_restart():
    """A dead server kills the watch; changes made during the outage are
    dispatched after the informer relists over HTTP (the JAX test
    ``test_informer_survives_apiserver_restart``, on the port)."""
    backing = port_client.FakeClient()
    server = port_httpapi.ApiServer(backing).start()
    port = server.port
    client = port_httpapi.HttpClient(server.endpoint)
    adds, dels = [], []
    inf = Informer(client, "ConfigMap",
                   on_add=lambda o: adds.append(o["metadata"]["name"]),
                   on_delete=lambda o: dels.append(o["metadata"]["name"]))
    inf.start()
    try:
        inf.wait_for_cache_sync()
        client.create(new_object("ConfigMap", "before", "default"))
        assert _wait(lambda: "before" in adds)
        server.stop()
        backing.create(new_object("ConfigMap", "during", "default"))
        backing.delete("ConfigMap", "before", "default")
        server = port_httpapi.ApiServer(backing, port=port).start()
        assert _wait(lambda: "during" in adds and "before" in dels, 15)
        client.create(new_object("ConfigMap", "after", "default"))
        assert _wait(lambda: "after" in adds)
    finally:
        inf.stop()
        server.stop()


def test_informer_resumes_after_stream_drop():
    """A dropped HTTP watch is replaced by a resume from the backlog, not
    a relist, and events after the drop arrive exactly once."""
    backing = port_client.FakeClient()
    server = port_httpapi.ApiServer(backing).start()
    client = port_httpapi.HttpClient(server.endpoint)
    adds = []
    inf = Informer(client, "ConfigMap",
                   on_add=lambda o: adds.append(o["metadata"]["name"]))
    inf.start()
    try:
        inf.wait_for_cache_sync()
        with faultpoints.injected("k8sclient.watch.drop=nth:1"):
            assert _wait(lambda: inf.reconnect_count >= 1, 15)
        assert inf.resume_count >= 1 and inf.relist_count == 0
        backing.create(new_object("ConfigMap", "during", "default"))
        assert _wait(lambda: "during" in adds, 15)
        assert adds == ["during"]
    finally:
        inf.stop()
        server.stop()


# -- the port's FakeClient under concurrent writers and a stalled watcher ----

def test_concurrent_status_writers_each_commit_their_own():
    """Concurrent update_status calls: each caller gets its own committed
    object, and every write is fanned out in commit order."""
    c = port_client.FakeClient()
    n = 24
    for i in range(n):
        c.create(new_object("Widget", f"w{i}", "default"))
    w = c.watch("Widget")
    barrier = threading.Barrier(n)
    results, errors = {}, []

    def writer(i):
        obj = c.get("Widget", f"w{i}", "default")
        obj["status"] = {"i": i}
        barrier.wait()
        try:
            results[i] = c.update_status(obj)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors and len(results) == n
    assert all(results[i]["status"] == {"i": i} for i in range(n))
    rvs = []
    for _ in range(n):
        ev = w.next(timeout=5)
        rvs.append(int(ev.object["metadata"]["resourceVersion"]))
    assert rvs == sorted(rvs)
    w.stop()


def test_status_update_errors_leave_the_store_untouched():
    """A status write to a missing object is NotFound, one from a stale
    resourceVersion a Conflict; neither changes what is stored, as in the
    JAX FakeClient."""
    results = []
    for mod in (port_client, jax_client):
        c = mod.FakeClient()
        c.create(new_object("Widget", "ok", "default"))
        stale = c.get("Widget", "ok", "default")
        good = c.get("Widget", "ok", "default")
        good["status"] = {"v": 1}
        ghost = new_object("Widget", "ghost", "default")
        ghost["status"] = {"v": 2}
        with pytest.raises(mod.NotFoundError):
            c.update_status(ghost)
        assert c.update_status(good)["status"] == {"v": 1}
        stale["status"] = {"v": 3}
        with pytest.raises(mod.ConflictError):
            c.update_status(stale)
        results.append(c.get("Widget", "ok", "default")["status"])
    assert results == [{"v": 1}, {"v": 1}]


def test_stalled_watcher_is_disconnected():
    """A watcher that stops reading is cut off at its queue bound, with
    the events it missed counted on it; a healthy peer keeps receiving."""
    c = port_client.FakeClient()
    w = c.watch("Blob", max_queue=4)
    for i in range(10):
        c.create(new_object("Blob", f"b{i}", "default"))
    assert w.overflowed and not w.alive and w.dropped >= 1
    healthy = c.watch("Blob")
    c.create(new_object("Blob", "after", "default"))
    assert healthy.next(timeout=2).object["metadata"]["name"] == "after"
    healthy.stop()


def test_keep_alive_client_reuses_and_retries_its_connection():
    server = _serve("port")
    try:
        c = port_httpapi.HttpClient(server.endpoint)
        c.create(new_object("ConfigMap", "a", "default"))
        conn = c._local.conn
        c.get("ConfigMap", "a", "default")
        assert c._local.conn is conn
        conn.sock.close()          # a stale keep-alive socket
        assert c.get("ConfigMap", "a", "default")["metadata"]["name"] == "a"
        with pytest.raises(port_client.NotFoundError):
            c.get("ConfigMap", "zz", "default")
        other = []
        t = threading.Thread(target=lambda: other.append(
            (c.get("ConfigMap", "a", "default"), c._local.conn)))
        t.start()
        t.join(timeout=10)
        assert other and other[0][1] is not c._local.conn
    finally:
        server.stop()
