"""The port's ``run_allocator_scale``, held against the JAX package.

``TestAllocatorScaleHarness`` and ``TestChaosDefrag`` are the JAX tests of
the same names (``tests/test_allocator_placement.py``,
``tests/test_chaos.py``) with their arguments and assertions, on the
port's mesh: ``h100-8`` nodes in MIG mode, 64 memory slices each, whole-GPU
admission probes. ``TestAgainstJax`` replays the harness's seeded tape,
churn policy and probes through the JAX package's ``Allocator`` on a JAX
``FakeClient`` and through the port's, both given the port's published
slices: every op makes the same pick or the same refusal in both
strategies, and the replay's counts are the harness's. The admission rates
at 2 x 600 and ``target_util`` 0.8 are pinned, and each class of the
harness selects exactly one published profile.
"""

import copy

import pytest

from k8s_dra_driver_tpu.k8sclient import FakeClient as JaxFakeClient
from k8s_dra_driver_tpu.kubeletplugin import Allocator as JaxAllocator
from k8s_dra_driver_tpu.kubeletplugin import allocator as jax_allocator
from k8s_dra_driver_tpu_torch.internal.stresslab import (
    ALLOC_SCALE_CLASSES,
    ALLOC_SCALE_NODE_SLICES,
    SOAK_FAULT_MIX,
    alloc_scale_tape,
    alloc_scale_world,
    run_allocator_scale,
)
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.kubeletplugin import allocator as port_allocator
from k8s_dra_driver_tpu_torch.kubeletplugin.allocator import (
    STRATEGY_BEST_FIT,
    STRATEGY_FIRST_FIT,
    Allocator,
    eval_selector,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import partitions

#: the cross-check's and the pinned rates' size: 2 nodes x 600 claims
N_NODES, N_CLAIMS = 2, 600


class TestAllocatorScaleHarness:
    def test_smoke(self):
        """A tiny end-to-end run of the whole harness: both arms, the
        admission probes, the defrag leg — every oracle green."""
        r = run_allocator_scale(n_nodes=2, n_claims=600, defrag_probes=2,
                                defrag_timeout_s=8.0)
        assert r["error_count"] == 0, r["errors"]
        assert not r["leaks"], r["leaks"]
        for arm in ("first_fit", "best_fit"):
            assert r[arm]["overlap_audit"]["overcommitted"] == 0
            assert r[arm]["fragmentation_gauge_exported"]
        d = r["defrag"]
        assert d["alert_fired"]
        assert d["unblocked"] == d["probes"] == 2
        assert d["planner"]["preempted"] >= 1
        assert d["eviction_bound_held"]
        assert not d["stuck_victims"]


class TestChaosDefrag:
    """The defrag planner's preemption path under the soak fault mix,
    with the reallocator killed and recreated mid-preemption: every
    blocked probe unblocked, every evicted claim reallocated or cleanly
    failed, the per-blocked-claim eviction bound held, zero leaks, zero
    counter overcommit."""

    @pytest.mark.parametrize("seed", [3, 17])
    def test_preemption_under_fault_mix_and_realloc_crash(self, seed):
        out = run_allocator_scale(
            n_nodes=2, n_claims=800, seed=seed,
            defrag_probes=2, defrag_timeout_s=20.0,
            faults=SOAK_FAULT_MIX, fault_seed=seed,
            realloc_restart=True)
        assert out["error_count"] == 0, out["errors"]
        assert not out["leaks"], out["leaks"]
        d = out["defrag"]
        assert d["alert_fired"], d
        assert d["unblocked"] == d["probes"] == 2, d
        assert d["planner"]["preempted"] >= 1, d
        assert d["eviction_bound_held"], d
        assert not d["stuck_victims"], d
        assert d["realloc_restarted"], d
        for arm in ("first_fit", "best_fit"):
            assert out[arm]["overlap_audit"]["overcommitted"] == 0


# -- the replay against the JAX package's allocator ---------------------------

def _jax_world(n_nodes: int) -> JaxFakeClient:
    """A JAX ``FakeClient`` holding the port's DeviceClasses and published
    ResourceSlices (specs copied, metadata reduced to the name)."""
    port = FakeClient()
    alloc_scale_world(port, n_nodes)
    client = JaxFakeClient()
    for kind in ("DeviceClass", "ResourceSlice"):
        for o in port.list(kind):
            client.create({"apiVersion": o.get("apiVersion", "v1"),
                           "kind": kind,
                           "metadata": {"name": o["metadata"]["name"]},
                           "spec": copy.deepcopy(o["spec"])})
    return client


def _claim(name: str, cls: str) -> dict:
    return new_object(
        "ResourceClaim", name, "default", api_version="resource.k8s.io/v1",
        spec={"devices": {"requests": [{"name": "r", "exactly": {
            "deviceClassName": cls, "allocationMode": "ExactCount",
            "count": 1}}]}})


def _replay(client, alloc, allocation_error, tape: list, n_nodes: int,
            target_util: float = 0.8, probe_every: int = 10,
            warmup_frac: float = 0.3, pending_batch: int = 500) -> dict:
    """The harness's arm, op for op: pending batches, node-pinned
    allocations, the per-node release policy and the whole-GPU probes.
    Returns every op's pick ((pool, device) or None for a refusal) and the
    counts the harness reports."""
    sizes = {s: cls for s, (cls, _p) in ALLOC_SCALE_CLASSES.items()}
    live = {i: [] for i in range(n_nodes)}
    used = {i: 0 for i in range(n_nodes)}
    pending: list = []
    seq = 0
    ops: list = []
    n = {"allocations": 0, "releases": 0, "large_admitted": 0}
    warmup = int(len(tape) * warmup_frac)

    def pick(claim) -> tuple:
        r = claim["status"]["allocation"]["devices"]["results"][0]
        return (r["pool"], r["device"])

    for i in range(len(tape)):
        while len(pending) < pending_batch and seq < len(tape):
            size, node_i, _f = tape[seq]
            client.create(_claim(f"as-{seq}", sizes[size]))
            pending.append((f"as-{seq}", size, node_i))
            seq += 1
        name, size, node_i = pending.pop(0)
        frac = tape[i][2]
        try:
            got = alloc.allocate(client.get("ResourceClaim", name,
                                            "default"),
                                 node=f"node-{node_i}")
            ops.append(("allocate", name, pick(got)))
            n["allocations"] += 1
            live[node_i].append((name, size))
            used[node_i] += size
        except allocation_error:
            ops.append(("allocate", name, None))
            client.delete("ResourceClaim", name, "default")
        while live[node_i] and used[node_i] / ALLOC_SCALE_NODE_SLICES \
                > target_util:
            victim, units = live[node_i].pop(
                int(frac * len(live[node_i])) % len(live[node_i]))
            alloc.release(client.get("ResourceClaim", victim, "default"))
            client.delete("ResourceClaim", victim, "default")
            ops.append(("release", victim, None))
            n["releases"] += 1
            used[node_i] -= units
        if i + 1 > warmup and (i + 1) % probe_every == 0:
            p = (i + 1) // probe_every
            probe = f"as-large-{p}"
            client.create(_claim(probe, partitions.DEVICE_CLASS_GPU))
            try:
                got = alloc.allocate(client.get("ResourceClaim", probe,
                                                "default"),
                                     node=f"node-{p % n_nodes}")
                ops.append(("probe", probe, pick(got)))
                n["large_admitted"] += 1
                alloc.release(client.get("ResourceClaim", probe, "default"))
            except allocation_error:
                ops.append(("probe", probe, None))
            client.delete("ResourceClaim", probe, "default")
    return {"ops": ops, **n}


@pytest.fixture(scope="module")
def harness():
    """The port harness at 2 x 600, seed 0, without the defrag leg."""
    return run_allocator_scale(n_nodes=N_NODES, n_claims=N_CLAIMS,
                               defrag=False)


class TestAgainstJax:
    @pytest.mark.parametrize("strategy", [STRATEGY_FIRST_FIT,
                                          STRATEGY_BEST_FIT])
    def test_every_pick_is_the_jax_allocators(self, harness, strategy):
        """The tape through the JAX allocator and the port's on the same
        published slices: the same pick or refusal at every op, and the
        port replay's counts equal to what the harness reports."""
        tape = alloc_scale_tape(N_CLAIMS, N_NODES, 0)
        port_client = FakeClient()
        alloc_scale_world(port_client, N_NODES)
        port = _replay(port_client, Allocator(port_client, strategy=strategy),
                       port_allocator.AllocationError, tape, N_NODES)
        jax_client = _jax_world(N_NODES)
        jax = _replay(jax_client, JaxAllocator(jax_client,
                                               strategy=strategy),
                      jax_allocator.AllocationError, tape, N_NODES)
        assert len(port["ops"]) == len(jax["ops"])
        for k, (a, b) in enumerate(zip(port["ops"], jax["ops"])):
            assert a == b, f"op {k}: port {a}, JAX {b}"
        arm = harness["first_fit" if strategy == STRATEGY_FIRST_FIT
                      else "best_fit"]
        assert (port["allocations"], port["releases"],
                port["large_admitted"]) == (
            arm["allocations"], arm["releases"], arm["large_admitted"])
        assert any(op[2] is None for op in port["ops"] if op[0] == "probe")
        assert any(op[2] is not None for op in port["ops"]
                   if op[0] == "probe")

    def test_admission_rates_are_pinned(self, harness):
        """At 2 x 600 and target_util 0.8 first-fit admits 9 of 42
        whole-GPU probes and best-fit 15 of 42: the rates are functions of
        the seeded tape and the allocator alone."""
        ff, bf = harness["first_fit"], harness["best_fit"]
        assert harness["target_util"] == 0.8
        assert ff["large_attempted"] == bf["large_attempted"] == 42
        assert ff["large_admission_rate"] == 0.2143
        assert bf["large_admission_rate"] == 0.3571
        assert harness["admission_ratio"] >= 1.5
        assert harness["total_slices"] == N_NODES * 64
        for arm in (ff, bf):
            assert arm["error_count"] == 0
            assert arm["overlap_audit"]["overcommitted"] == 0
            assert 0 < arm["overlap_audit"]["slices_used"] \
                <= harness["total_slices"]


def test_each_class_selects_exactly_one_published_profile():
    """Every MIG class of the harness selects the placements of exactly its
    profile, and the probe class only the whole GPUs (the 1x8 boxes)."""
    client = FakeClient()
    alloc_scale_world(client, 1)
    (rs,) = client.list("ResourceSlice")
    devices = rs["spec"]["devices"]
    classes = {c["metadata"]["name"]: c["spec"]["selectors"][0]["cel"][
        "expression"] for c in client.list("DeviceClass")}
    assert set(classes) == {partitions.DEVICE_CLASS_GPU} | {
        cls for cls, _p in ALLOC_SCALE_CLASSES.values()}

    def attr(d, key):
        v = d["attributes"].get(key) or {}
        return next(iter(v.values()), None)

    def selects(expression, d):
        return eval_selector(expression, port_allocator._device_view(d))

    for size, (cls, profile) in ALLOC_SCALE_CLASSES.items():
        picked = [d for d in devices if selects(classes[cls], d)]
        assert picked and {attr(d, "profile") for d in picked} == {profile}
        assert {attr(d, "shape") for d in picked} == {f"1x{size}"}
    whole = [d for d in devices
             if selects(classes[partitions.DEVICE_CLASS_GPU], d)]
    assert len(whole) == 8
    assert {attr(d, "type") for d in whole} == {"gpu"}
    assert {attr(d, "shape") for d in whole} == {"1x8"}


def test_the_smokes_alloc_phase_at_a_small_size(capsys):
    """``chip_smoke.phase_alloc`` as the card runs it, at 2 x 600: every
    oracle holds, the pinned admission rates are printed, one ``alloc``
    line."""
    import chip_smoke

    out = chip_smoke.phase_alloc("mock", n_nodes=2, n_claims=600,
                                 defrag_probes=2, defrag_timeout_s=8.0)
    assert out["admission_ratio"] >= 1.5 and out["seconds"] > 0
    assert out["defrag"]["unblocked"] == out["defrag"]["probes"] == 2
    text = capsys.readouterr().out
    assert text.count("[alloc]") == 1
    assert "ff_admission=0.2143 bf_admission=0.3571" in text


def test_the_smokes_alloc_phase_holds_the_admission_bar(monkeypatch):
    """No fallback: an admission ratio under 1.5 fails the phase."""
    import chip_smoke

    def weak(**kw):
        return dict(run_allocator_scale(**kw), admission_ratio=1.2)

    monkeypatch.setattr(chip_smoke, "run_allocator_scale", weak)
    with pytest.raises(SystemExit, match="admission ratio 1.2"):
        chip_smoke.phase_alloc("mock", n_nodes=2, n_claims=600,
                               defrag_probes=2, defrag_timeout_s=8.0)


def test_a_claim_drained_again_mid_pass_stays_pending():
    """The defrag leg preempts a victim a second time while the
    reallocator is still finishing its first drain: the second notice
    must keep the claim pending (the pass that finished the first drain
    may not drop it), and the next pass reallocates it off the second
    avoided placement."""
    import json

    from k8s_dra_driver_tpu_torch.kubeletplugin.remediation import (
        ANN_DRAIN,
        ClaimReallocator,
    )

    client = FakeClient()
    alloc_scale_world(client, 1)
    alloc = Allocator(client)
    cls = ALLOC_SCALE_CLASSES[8][0]
    claim = alloc.allocate(client.create(_claim("victim", cls)),
                           node="node-0")

    def drain(avoid: str) -> dict:
        c = client.get("ResourceClaim", "victim", "default")
        c["metadata"].setdefault("annotations", {})[ANN_DRAIN] = json.dumps(
            {"device": avoid, "avoid": {"pool": "node-0", "device": avoid}})
        return client.update(c)

    first = claim["status"]["allocation"]["devices"]["results"][0]["device"]
    realloc = ClaimReallocator(client, allocator=alloc)
    realloc._on_claim(drain(first))
    inner = realloc._process
    second = []

    def process(uid, name, ns):
        done = inner(uid, name, ns)
        c = client.get("ResourceClaim", name, ns)
        second.append(c["status"]["allocation"]["devices"]["results"][0][
            "device"])
        realloc._on_claim(drain(second[0]))   # preempted again, mid-pass
        return done

    realloc._process = process
    assert realloc.reconcile_once() == 1
    assert second and second[0] != first
    assert realloc.pending_count() == 1, "the second drain was dropped"
    realloc._process = inner
    assert realloc.reconcile_once() == 1 and realloc.pending_count() == 0
    c = client.get("ResourceClaim", "victim", "default")
    assert ANN_DRAIN not in (c["metadata"].get("annotations") or {})
    last = c["status"]["allocation"]["devices"]["results"][0]["device"]
    assert last != second[0]
    assert realloc.reallocated == 2


def test_a_victim_as_large_as_the_blocked_claim_is_not_evicted():
    """A victim as large as the blocked claim that holds a box of a shape
    the claim can take would need that very box: the planner refuses it
    (on this mesh a whole-GPU or 7g.80gb claim for a whole-GPU claim). As
    large but of other shapes, or smaller, it stays movable, as in the
    JAX planner."""
    from k8s_dra_driver_tpu_torch.kubeletplugin.remediation import (
        DefragPlanner,
    )

    client = FakeClient()
    alloc_scale_world(client, 1)
    alloc = Allocator(client)
    planner = DefragPlanner(client, alloc)
    for name, size in (("whole", 8), ("half", 4)):
        alloc.allocate(client.create(_claim(
            name, ALLOC_SCALE_CLASSES[size][0])), node="node-0")
    probe = client.create(_claim("probe", partitions.DEVICE_CLASS_GPU))
    rows = {v["name"]: v for opt in alloc.placement_options(probe)
            for v in opt["victims"]}
    whole, half = rows["whole"], rows["half"]
    assert (whole["chips"], whole["shapes"]) == (8, ["1x8"])
    assert (half["chips"], half["shapes"]) == (4, ["1x4"])
    wide = frozenset({"1x8"})
    assert planner._movable([whole], 8, wide) is None
    assert planner._movable([half], 8, wide) == [{**half, "canary": False}]
    assert planner._movable([half], 4, frozenset({"1x4"})) is None
    assert planner._movable([half], 4, frozenset({"2x2"})) == [
        {**half, "canary": False}]
    assert planner._movable([half], 4) == [{**half, "canary": False}]


#: worlds of one h100-8 node as (claim, class size, device) placements;
#: size 0 is the whole-GPU class
_WHOLE = [(f"whole-{g}", 0, f"gpu-{g}") for g in range(6)]
_PLANNER_WORLDS = {
    "a-pin-in-every-gpu": [(f"pin-{g}", 1, f"gpu-{g}-mig-1g10gb-{g % 7}-1")
                           for g in range(8)],
    "a-smaller-victim-is-cheaper": _WHOLE + [
        (f"half-{g}", 4, f"gpu-{g}-mig-3g40gb-0-4") for g in (6, 7)],
    "a-same-size-victim-is-cheaper": _WHOLE + [
        (f"pin-{g}-{k}", 1, f"gpu-{g}-mig-1g10gb-{k}-1")
        for g in (6, 7) for k in (0, 1)],
}
#: each world's first hint as (target device, victims): JAX's, then the
#: port's. They differ only where the cheapest placement's victim is a
#: whole GPU: JAX evicts it (it turns blocked in its place), the port
#: refuses it and clears the GPU that holds two pins.
_PLANNER_HINTS = {
    "a-pin-in-every-gpu": (("gpu-0", ["default/pin-0"]),) * 2,
    "a-smaller-victim-is-cheaper": (("gpu-6", ["default/half-6"]),) * 2,
    "a-same-size-victim-is-cheaper": (
        ("gpu-0", ["default/whole-0"]),
        ("gpu-6", ["default/pin-6-0", "default/pin-6-1"])),
}


def _plan_first_hint(client, alloc, allocation_error, planner_cls,
                     world: list) -> tuple:
    sizes = {s: cls for s, (cls, _p) in ALLOC_SCALE_CLASSES.items()}
    sizes[0] = partitions.DEVICE_CLASS_GPU
    for name, size, device in world:
        c = client.create(_claim(name, sizes[size]))
        c.setdefault("status", {})["allocation"] = {"devices": {"results": [
            {"request": "r", "driver": "gpu.nvidia.com", "pool": "node-0",
             "device": device}]}}
        client.update_status(c)
    with pytest.raises(allocation_error):
        alloc.allocate(client.create(_claim("probe",
                                            partitions.DEVICE_CLASS_GPU)))
    planner = planner_cls(client, alloc)
    assert planner.plan_once()["planned"] == 1
    hint = planner.hints()[0]
    return hint["target_device"], sorted(hint["victims"])


@pytest.mark.parametrize("world", sorted(_PLANNER_WORLDS))
def test_the_planner_against_the_jax_planner(world):
    """The JAX package's ``DefragPlanner`` and the port's, each on its own
    allocator over the port's published slices, plan for the same blocked
    whole-GPU claim: the same target and victims, except where the port's
    same-size rule applies (named in ``_PLANNER_HINTS``)."""
    from k8s_dra_driver_tpu.kubeletplugin.remediation import (
        DefragPlanner as JaxDefragPlanner,
    )
    from k8s_dra_driver_tpu_torch.kubeletplugin.remediation import (
        DefragPlanner,
    )

    jax_client = _jax_world(1)
    port_client = FakeClient()
    alloc_scale_world(port_client, 1)
    got = (
        _plan_first_hint(jax_client, JaxAllocator(jax_client),
                         jax_allocator.AllocationError, JaxDefragPlanner,
                         _PLANNER_WORLDS[world]),
        _plan_first_hint(port_client, Allocator(port_client),
                         port_allocator.AllocationError, DefragPlanner,
                         _PLANNER_WORLDS[world]))
    assert got == _PLANNER_HINTS[world]


def test_a_nominated_placement_is_held_for_its_claim():
    """The planner's cleared placement is nominated for its blocked claim:
    any other claim is steered off it (here: refused, nothing else being
    free), the nominated claim lands there, and the nomination goes with
    that allocation."""
    client = FakeClient()
    alloc_scale_world(client, 1)
    alloc = Allocator(client)
    whole = partitions.DEVICE_CLASS_GPU
    for g in range(7):
        alloc.allocate(client.create(_claim(f"fill-{g}", whole)),
                       node="node-0")
    owner = client.create(_claim("owner", whole))
    alloc.nominate("node-0", "gpu-7", owner["metadata"]["uid"])
    intruder = client.create(_claim("intruder", ALLOC_SCALE_CLASSES[1][0]))
    with pytest.raises(port_allocator.AllocationError):
        alloc.allocate(intruder, node="node-0")
    got = alloc.allocate(owner, node="node-0")
    assert got["status"]["allocation"]["devices"]["results"][0][
        "device"] == "gpu-7"
    assert alloc.nominated == {}


def test_a_blocked_claim_waits_for_its_plans_victims():
    """While a victim of a blocked claim's plan is still draining, later
    passes plan nothing more for it (no second target, no budget spent);
    nor once the victims moved and its nominated placement waits free; the
    claim then lands there."""
    from k8s_dra_driver_tpu_torch.kubeletplugin.remediation import (
        ANN_DRAIN,
        ClaimReallocator,
        DefragPlanner,
    )

    client = FakeClient()
    alloc_scale_world(client, 1)
    alloc = Allocator(client)
    small = ALLOC_SCALE_CLASSES[1][0]
    for g in range(8):   # one 1g.10gb pin in every GPU
        c = client.create(_claim(f"pin-{g}", small))
        c.setdefault("status", {})["allocation"] = {"devices": {"results": [
            {"request": "r", "driver": "gpu.nvidia.com", "pool": "node-0",
             "device": f"gpu-{g}-mig-1g10gb-{g % 7}-1"}]}}
        client.update_status(c)
    probe = client.create(_claim("probe", partitions.DEVICE_CLASS_GPU))
    with pytest.raises(port_allocator.AllocationError):
        alloc.allocate(probe)
    planner = DefragPlanner(client, alloc)
    assert planner.plan_once()["preempted"] == 1
    for _ in range(3):
        assert planner.plan_once() == {"planned": 0, "preempted": 0,
                                       "skipped": 0, "resolved": 0}
    (target,) = alloc.nominated
    realloc = ClaimReallocator(client, allocator=alloc)
    for c in client.list("ResourceClaim"):
        if ANN_DRAIN in (c["metadata"].get("annotations") or {}):
            realloc._on_claim(c)
    assert realloc.reconcile_once() == 1
    assert planner.plan_once() == {"planned": 0, "preempted": 0,
                                   "skipped": 0, "resolved": 0}
    assert list(alloc.nominated) == [target]
    got = alloc.allocate(client.get("ResourceClaim", "probe", "default"))
    assert (got["status"]["allocation"]["devices"]["results"][0]["pool"],
            got["status"]["allocation"]["devices"]["results"][0][
                "device"]) == target
    assert planner.preempted == 1 and alloc.nominated == {}


@pytest.mark.parametrize("resolution", ["deleted-while-cleared",
                                        "allocated-elsewhere",
                                        "allocated-idempotently"])
def test_a_nomination_goes_with_its_blocked_claim(resolution):
    """A planned claim that leaves the blocked path behind the planner's
    back takes its nomination with it: deleted after the alert cleared
    (the disarm releases it), allocated by another allocator (the
    disarmed poll releases it), or handed back by this allocator's
    idempotent path. Either way another whole-GPU claim then lands on
    the cleared GPU."""
    from types import SimpleNamespace

    from k8s_dra_driver_tpu_torch.kubeletplugin.remediation import (
        ANN_DRAIN,
        ClaimReallocator,
        DefragPlanner,
    )
    from k8s_dra_driver_tpu_torch.pkg.slo import SLO_ALLOCATION_ADMISSION

    client = FakeClient()
    alloc_scale_world(client, 1)
    alloc = Allocator(client)
    small, whole = ALLOC_SCALE_CLASSES[1][0], partitions.DEVICE_CLASS_GPU
    for g in range(8):   # one 1g.10gb pin in every GPU
        c = client.create(_claim(f"pin-{g}", small))
        c.setdefault("status", {})["allocation"] = {"devices": {"results": [
            {"request": "r", "driver": "gpu.nvidia.com", "pool": "node-0",
             "device": f"gpu-{g}-mig-1g10gb-{g % 7}-1"}]}}
        client.update_status(c)
    probe = client.create(_claim("probe", whole))
    with pytest.raises(port_allocator.AllocationError):
        alloc.allocate(probe)
    planner = DefragPlanner(client, alloc)
    assert planner.plan_once()["preempted"] == 1
    (target,) = alloc.nominated
    realloc = ClaimReallocator(client, allocator=alloc)
    for c in client.list("ResourceClaim"):
        if ANN_DRAIN in (c["metadata"].get("annotations") or {}):
            realloc._on_claim(c)
    assert realloc.reconcile_once() == 1
    if resolution == "deleted-while-cleared":
        planner.on_alert(SimpleNamespace(slo=SLO_ALLOCATION_ADMISSION,
                                         transition="cleared"))
        assert alloc.nominated == {target: probe["metadata"]["uid"]}, \
            "the claim is still blocked: its nomination stays"
        client.delete("ResourceClaim", "probe", "default")
        planner.on_alert(SimpleNamespace(slo=SLO_ALLOCATION_ADMISSION,
                                         transition="cleared"))
    else:
        got = Allocator(client).allocate(
            client.get("ResourceClaim", "probe", "default"))
        assert alloc.nominated == {target: probe["metadata"]["uid"]}
        if resolution == "allocated-elsewhere":
            assert planner.maybe_plan() == {} and not planner.armed
        else:
            assert alloc.allocate(got) == got
        alloc.release(got)
        client.delete("ResourceClaim", "probe", "default")
    assert alloc.nominated == {} and not alloc.blocked
    other = alloc.allocate(client.create(_claim("other", whole)))
    r = other["status"]["allocation"]["devices"]["results"][0]
    assert (r["pool"], r["device"]) == target
