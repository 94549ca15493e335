"""The port store's wire-path disciplines and ``run_wire_path``, held
against the JAX package.

``TestStatusCoalescing``, ``TestBackpressureCounters`` and
``TestHttpKeepAlive`` are the JAX cases of ``tests/test_wirepath.py`` with
their assertions, on the port's ``FakeClient``, its ``gpu_dra_`` metric
families and its HTTP client; the fuzzer case runs under the port's
``racelab.fuzz`` with its race detector on. ``TestAgainstJax``
drives one seeded single-threaded sequence of creates, status writes,
updates, deletes and LISTs through the JAX and the port ``FakeClient`` in
every ``coalesce_status`` x ``fanout_copy`` mode: equal stores, equal watch
events and equal ``wire_path_snapshot()`` ledgers. Then the port's
``run_wire_path`` at 20 cycles, with the JAX harness's result keys.
"""

import random
import threading
import time

import pytest

from k8s_dra_driver_tpu.internal.stresslab import (
    run_wire_path as jax_run_wire_path,
)
from k8s_dra_driver_tpu.k8sclient import FakeClient as JaxFakeClient
from k8s_dra_driver_tpu.k8sclient import client as jax_client
from k8s_dra_driver_tpu_torch.internal.stresslab import run_wire_path
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import (
    AlreadyExistsError,
    ConflictError,
    NotFoundError,
    new_object,
)
from k8s_dra_driver_tpu_torch.k8sclient.httpapi import ApiServer, HttpClient
from k8s_dra_driver_tpu_torch.pkg import faultpoints, racelab
from k8s_dra_driver_tpu_torch.pkg.metrics import default_wirepath_metrics


# -- status-patch coalescing --------------------------------------------------

class TestStatusCoalescing:
    def _seed(self, c: FakeClient, n: int):
        for i in range(n):
            c.create(new_object("ResourceClaim", f"c{i}", "default"))

    def test_concurrent_writers_batch(self):
        """N concurrent status writers commit in fewer batches than
        patches — the group-commit window coalesces — and every writer's
        patch lands. A small injected commit latency holds each batch's
        apply window open so followers pile up behind the leader."""
        c = FakeClient(coalesce_status=True)
        n = 24
        self._seed(c, n)
        start = threading.Barrier(n)

        def write(i: int):
            start.wait(5.0)
            o = c.get("ResourceClaim", f"c{i}", "default")
            o.setdefault("status", {})["tick"] = i
            c.update_status(o)

        with faultpoints.injected("k8sclient.fake.commit=latency:0.005"):
            ts = [threading.Thread(target=write, args=(i,))
                  for i in range(n)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(10.0)
        snap = c.wire_path_snapshot()
        assert snap["status_batched"] == n
        assert snap["status_batches"] < n, \
            "every patch committed alone — the window never coalesced"
        for i in range(n):
            assert c.get("ResourceClaim", f"c{i}",
                         "default")["status"]["tick"] == i

    def test_per_txn_error_isolation(self):
        """One member's NotFound fails only that member; batchmates
        commit normally."""
        c = FakeClient(coalesce_status=True)
        self._seed(c, 2)
        good = c.get("ResourceClaim", "c0", "default")
        good.setdefault("status", {})["ok"] = True
        ghost = new_object("ResourceClaim", "nope", "default")
        ghost["status"] = {"ok": False}
        errs = []

        def write_ghost():
            try:
                c.update_status(ghost)
            except Exception as e:  # noqa: BLE001 — asserted below
                errs.append(e)

        t = threading.Thread(target=write_ghost)
        t.start()
        c.update_status(good)
        t.join(5.0)
        assert len(errs) == 1 and isinstance(errs[0], NotFoundError)
        assert c.get("ResourceClaim", "c0", "default")["status"]["ok"]

    def test_commit_fault_routed_to_its_own_patch(self):
        """The commit point's error modes fire per patch inside the
        batch: the injected patch fails, the rest of the window commits."""
        c = FakeClient(coalesce_status=True)
        self._seed(c, 1)
        o = c.get("ResourceClaim", "c0", "default")
        o.setdefault("status", {})["v"] = 1
        with faultpoints.injected("k8sclient.fake.commit=first:1:conflict"):
            with pytest.raises(ConflictError):
                c.update_status(o)
            o2 = c.get("ResourceClaim", "c0", "default")
            o2.setdefault("status", {})["v"] = 2
            c.update_status(o2)
        assert c.get("ResourceClaim", "c0", "default")["status"]["v"] == 2

    def test_uncoalesced_mode_unchanged(self):
        c = FakeClient(coalesce_status=False)
        self._seed(c, 1)
        o = c.get("ResourceClaim", "c0", "default")
        o.setdefault("status", {})["v"] = 9
        c.update_status(o)
        assert c.get("ResourceClaim", "c0", "default")["status"]["v"] == 9
        snap = c.wire_path_snapshot()
        assert snap["status_batches"] == 0 and snap["status_batched"] == 0

    def test_batch_size_observed_in_histogram(self):
        h = default_wirepath_metrics().status_coalesce_batch_size
        assert h.name == "gpu_dra_status_coalesce_batch_size"
        before = h.count(kind="ResourceClaim")
        c = FakeClient(coalesce_status=True)
        self._seed(c, 1)
        o = c.get("ResourceClaim", "c0", "default")
        o.setdefault("status", {})["v"] = 1
        c.update_status(o)
        assert h.count(kind="ResourceClaim") == before + 1


# -- counted watcher backpressure ---------------------------------------------

class TestBackpressureCounters:
    def test_drop_to_relist_is_counted_never_silent(self):
        """The stalled watcher is disconnected within its bound and BOTH
        ledgers tick: the client snapshot and the metric family."""
        m = default_wirepath_metrics()
        disc0 = m.backpressure_disconnects_total.value(kind="Pod")
        drop0 = m.backpressure_dropped_total.value(kind="Pod")
        c = FakeClient()
        w = c.watch("Pod", max_queue=4)
        for i in range(8):
            c.create(new_object("Pod", f"p{i}"))
        assert not w.alive and w.events.qsize() <= 4
        snap = c.wire_path_snapshot()
        assert snap["overflow_disconnects"] == 1
        assert snap["dropped_events"] >= 1
        assert m.backpressure_disconnects_total.value(
            kind="Pod") == disc0 + 1
        assert m.backpressure_dropped_total.value(kind="Pod") > drop0

    def test_healthy_watcher_unaffected_by_stalled_peer(self):
        """A stalled watcher being cut off must not slow or starve a
        draining one — every event still arrives promptly."""
        c = FakeClient()
        stalled = c.watch("Pod", max_queue=2)
        healthy = c.watch("Pod")
        lat = []
        for i in range(12):
            t0 = time.perf_counter()
            c.create(new_object("Pod", f"p{i}"))
            ev = healthy.next(timeout=1.0)
            lat.append(time.perf_counter() - t0)
            assert ev is not None and ev.type == "ADDED"
            assert ev.object["metadata"]["name"] == f"p{i}"
        assert not stalled.alive          # the peer WAS cut off
        assert max(lat) < 0.5, "healthy watcher stalled behind the drop"
        healthy.stop()

    def test_drop_path_under_seeded_schedule_fuzzer(self):
        """The overflow-disconnect path under the seeded schedule fuzzer:
        perturbed interleavings of committers vs the consumer must neither
        race nor lose the drop accounting."""
        was_active = racelab.active()
        racelab.enable()
        try:
            for seed in (3, 17):
                racelab.reset()
                with racelab.fuzz(seed=seed):
                    c = FakeClient()
                    w = c.watch("Pod", max_queue=4)

                    def burst(k: int):
                        for i in range(6):
                            c.create(new_object("Pod", f"s{seed}-w{k}-{i}"))

                    ts = [threading.Thread(target=burst, args=(k,))
                          for k in range(3)]
                    for t in ts:
                        t.start()
                    for t in ts:
                        t.join(5.0)
                    snap = c.wire_path_snapshot()
                    assert snap["overflow_disconnects"] == 1
                    assert snap["dropped_events"] >= 1
                    assert not w.alive
                assert racelab.reports() == [], \
                    f"seed {seed}: the drop path raced"
                racelab.reset()
        finally:
            racelab.reset()
            if not was_active:
                racelab.disable()


# -- the keep-alive HTTP client -----------------------------------------------

class TestHttpKeepAlive:
    @pytest.fixture()
    def cluster(self):
        server = ApiServer().start()
        client = HttpClient(server.endpoint)
        yield server, client
        server.stop()

    def test_connection_reused_across_requests(self, cluster):
        _server, client = cluster
        client.create(new_object("ConfigMap", "a"))
        conn = client._local.conn
        assert conn is not None
        for _ in range(5):
            client.get("ConfigMap", "a")
        assert client._local.conn is conn, \
            "per-thread connection must persist across requests"

    def test_stale_connection_retried_once(self, cluster):
        """A connection the peer closed while idle is dropped and the
        request replayed on a fresh one — invisible to the caller."""
        _server, client = cluster
        client.create(new_object("ConfigMap", "a"))
        client._local.conn.sock.close()   # simulate idle keep-alive death
        assert client.get("ConfigMap", "a")["metadata"]["name"] == "a"

    def test_error_mapping_survives_keep_alive(self, cluster):
        _server, client = cluster
        client.create(new_object("ConfigMap", "a"))
        with pytest.raises(AlreadyExistsError):
            client.create(new_object("ConfigMap", "a"))
        with pytest.raises(NotFoundError):
            client.get("ConfigMap", "ghost")
        stale = client.get("ConfigMap", "a")
        fresh = dict(stale, metadata=dict(stale["metadata"]))
        client.update(fresh)              # bumps the rv server-side
        stale["data"] = {"x": "1"}
        with pytest.raises(ConflictError):
            client.update(stale)

    def test_per_thread_connections_are_independent(self, cluster):
        _server, client = cluster
        client.create(new_object("ConfigMap", "a"))
        main_conn = client._local.conn
        seen = []

        def worker():
            client.get("ConfigMap", "a")
            seen.append(client._local.conn)

        t = threading.Thread(target=worker)
        t.start()
        t.join(5.0)
        assert seen and seen[0] is not None and seen[0] is not main_conn
        assert client._local.conn is main_conn


# -- the two stores on one seeded sequence ------------------------------------

#: metadata a store mints at random or from the clock
_MINTED = ("uid", "creationTimestamp")


def _norm(obj: dict) -> dict:
    o = dict(obj)
    o["metadata"] = {k: v for k, v in obj["metadata"].items()
                     if k not in _MINTED}
    return o


def _drive(client, new, seed: int) -> dict:
    """One seeded single-threaded sequence of creates, status writes,
    updates, deletes and LIST pages over two kinds, with a draining watch
    and a never-read ``max_queue=4`` watch on each kind. Returns the
    store, the drained events and the wire-path ledger."""
    rng = random.Random(seed)
    kinds = ("ResourceClaim", "ConfigMap")
    live: dict = {k: [] for k in kinds}
    watches = {k: client.watch(k, namespace="default") for k in kinds}
    stalled = [client.watch(k, namespace="default", max_queue=4)
               for k in kinds]
    events: list = []
    serial = 0

    def drain():
        for k in kinds:
            while True:
                ev = watches[k].next(timeout=0)
                if ev is None or ev.type == "BOOKMARK":
                    break
                events.append((ev.type, ev.object["kind"],
                               ev.object["metadata"]["name"],
                               ev.object["metadata"]["resourceVersion"]))

    for _ in range(240):
        kind = rng.choice(kinds)
        roll = rng.random()
        if roll < 0.3 or not live[kind]:
            serial += 1
            name = f"o{serial}"
            client.create(new(kind, name, "default",
                              spec={"n": serial}))
            live[kind].append(name)
        elif roll < 0.6:
            o = client.get(kind, rng.choice(live[kind]), "default")
            o["status"] = {"tick": rng.randrange(1000),
                           "ok": rng.random() < 0.5}
            client.update_status(o)
        elif roll < 0.75:
            o = client.get(kind, rng.choice(live[kind]), "default")
            o["metadata"].setdefault("labels", {})["v"] = str(
                rng.randrange(10))
            client.update(o)
        elif roll < 0.85:
            name = live[kind].pop(rng.randrange(len(live[kind])))
            client.delete(kind, name, "default")
        else:
            client.list_page_wire(kind, "default", limit=rng.randint(1, 8))
        drain()
    drain()
    for w in (*watches.values(), *stalled):
        w.stop()
    return {"store": {k: [_norm(o) for o in client.list(k, "default")]
                      for k in kinds},
            "events": events,
            "stalled_dropped": [w.dropped for w in stalled],
            "ledger": client.wire_path_snapshot()}


class TestAgainstJax:
    @pytest.mark.parametrize("coalesce", [True, False])
    @pytest.mark.parametrize("fanout_copy", [False, True])
    def test_same_sequence_same_store_events_and_ledger(self, coalesce,
                                                        fanout_copy):
        kw = dict(coalesce_status=coalesce, fanout_copy=fanout_copy)
        for seed in (0, 1):
            port = _drive(FakeClient(**kw), new_object, seed)
            jax = _drive(JaxFakeClient(**kw), jax_client.new_object, seed)
            assert port["store"] == jax["store"]
            assert port["events"] == jax["events"]
            assert port["stalled_dropped"] == jax["stalled_dropped"]
            assert port["ledger"] == jax["ledger"]
            ledger = port["ledger"]
            assert ledger["overflow_disconnects"] == 2
            assert ledger["wire_cache_hits"] > 0
            assert (ledger["fanout_copies"] == ledger["fanout_events"]
                    if fanout_copy else ledger["fanout_copies"] == 0)
            assert (ledger["status_batches"] > 0) == coalesce


# -- the harness ----------------------------------------------------------------

def _keys(d, prefix=""):
    """Every key path of a nested result dict (lists of rows not
    descended: their rows are data, not keys)."""
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("encoder_fallbacks",):
            out |= _keys(v, prefix + k + ".")
    return out


def test_run_wire_path_holds_its_oracles_with_jax_keys():
    r = run_wire_path(cycles=20)
    assert r["error_count"] == 0, r["errors"]
    for arm in ("baseline", "optimized"):
        a = r[arm]
        assert a["claim_ready_http"]["ops"] == 20
        assert not a["leaked_claims"]
        assert a["overcommit"]["overcommitted"] == 0
    assert r["baseline"]["copies_per_event"] == 1.0
    assert r["optimized"]["copies_per_event"] == 0.0
    assert r["copies_halved"]
    assert r["backpressure_counted"]
    assert r["optimized"]["wire_path"]["status_batched"] > 0
    assert r["p99_over_p50"] >= 1.0
    assert r["contention_before"], "the profiled burst saw no contention"
    assert _keys(r) == _keys(jax_run_wire_path(cycles=4))


def _one_gpu_node():
    from k8s_dra_driver_tpu_torch.gpulib import device_lib as dl

    profile = dl._h100_8_profile(0)
    profile["gpus"] = profile["gpus"][:1]
    lib = dl.MockDeviceLib(profile)
    return lib, lib.enumerate_gpus()[0]


#: the wire phase's served claim at a CPU engine's size
SMALL_WIRE_WIDTH = {"max_batch": 4, "heads": 2, "head_dim": 8, "kv_cap": 64,
                    "prompts": (8, 40), "new_tokens": 4, "requests": 6,
                    "device": "cpu"}


def test_the_smokes_wire_phase_on_a_mock_node(tmp_path, monkeypatch,
                                              capsys):
    """``chip_smoke.phase_wire`` as the card runs it, on a mock node of one
    GPU with a small CPU engine: the harness's oracles, then the claim
    created over HTTP and seen Ready on the HTTP watch under the
    contenders, its status writes group-committed, the stalled watch cut
    off and counted, the engine's batch served, nothing left."""
    import chip_smoke
    from k8s_dra_driver_tpu_torch.compute import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    lib, gpu = _one_gpu_node()
    out = chip_smoke.phase_wire("mock", 0, lib, gpu, width={
        **SMALL_WIRE_WIDTH, "uuids": {gpu.uuid: 0}}, cycles=8)
    assert out["launches"] == 0 and out["decode_steps"] > 0  # plain on CPU
    assert out["claim_ready_http_ms"] > 0
    assert out["ttfb_ms"] >= out["claim_ready_http_ms"]
    assert out["status_batched"] >= out["status_batches"] > 0
    assert out["overflow_disconnects"] >= 1 and out["stalled_dropped"] >= 1
    assert out["residue"] == [] and out["contender_errors"] == []
    assert out["max_abs_err"] is None
    assert out["harness"]["copies_halved"]
    text = capsys.readouterr().out
    assert text.count("[wire]") == 2 and "residue=[]" in text


def test_the_smokes_wire_phase_holds_the_harness_oracles(tmp_path,
                                                         monkeypatch):
    """No fallback: a harness run whose backpressure went uncounted fails
    the phase before the served claim."""
    import chip_smoke

    def uncounted(**kw):
        return dict(run_wire_path(**kw), backpressure_counted=False)

    monkeypatch.setattr(chip_smoke, "run_wire_path", uncounted)
    lib, gpu = _one_gpu_node()
    with pytest.raises(SystemExit, match="backpressure not counted"):
        chip_smoke.phase_wire("mock", 0, lib, gpu, width={
            **SMALL_WIRE_WIDTH, "uuids": {gpu.uuid: 0}}, cycles=2)
