"""crashlab: exhaustive crash-point exploration with a recovery oracle.

The plugin's restart story hangs on one claim: a kubelet plugin killed at
ANY instruction recovers cleanly by replaying ``checkpoint.json``
(``pkg/durability.py`` for the on-disk protocol). The chaos tests prove
that at a handful of hand-picked ``crash-nth`` positions; this module
proves it at EVERY position: enumerate the space deterministically, assert
the oracle, count the coverage.

**Explorer.** Every crash-capable fault point (:data:`CRASH_CAPABLE_POINTS`
— the write-side points plus ``devicestate.prepare`` and
``checkpoint.read``) is probed per scenario with a never-firing
schedule: the per-point hit counters (``FaultPlan.hits()``) ARE the
crash-site list — a pure function of the registry and the scenario's
code path, no wall clock, so the same corpus always enumerates the same
sites. For each site ``(point, hit#)`` the scenario is re-run from scratch
with ``<point>=crash-nth:<hit>``; the
:class:`~k8s_dra_driver_tpu_torch.pkg.faultpoints.FaultCrash` tears
through the stack like a SIGKILL (it is a ``BaseException``), the
in-memory stack is discarded, a fresh stack is built over the same state
directory, and the recovery ORACLE is asserted: bootstrap succeeds (main
checkpoint or ``.bak``, never an unhandled crash), replay is idempotent,
tombstone semantics hold, no prepares or CDI specs leak, and a boot-id
change discards prepared claims.

**Torn-file injector.** Process crashes land only in the ``.tmp``; a
power loss mid-``os.replace`` can tear the PUBLISHED file (a journaled
rename may publish the name before the data). The injector simulates
that byte-level: truncate or garbage the main checkpoint, optionally the
``.bak`` too, optionally flip the boot id — and asserts the
``bootstrap_checkpoint`` recovery matrix: reboot-torn main recovers from
the ``.bak`` (discarding every claim), torn-with-no-backup resets empty
with the startup sweep healing artifacts, and SAME-boot corruption
refuses loudly (``CorruptCheckpointError``) instead of misparsing or
silently resuming from stale state.

**Coverage is counted.** A crash-capable point in a scenario's path that
was never crashed fails the run, and a crash-capable point in NO
scenario's path is reported (``uncrashed_capable_points``).

The GPU stack of the checkpoint-backed scenarios is a ``GpuDriver`` on the
``h100-8`` mock (:func:`_gpu_env`); a scenario's ``setup`` may swap
``env["new_driver"]`` for a driver over another device library, such as
a card's own.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from k8s_dra_driver_tpu_torch.pkg import faultpoints
from k8s_dra_driver_tpu_torch.pkg.faultpoints import FaultCrash, FaultPlan

#: Fault points whose ``crash-nth`` mode simulates process death at a
#: meaningful durability boundary — the explorer's enumeration universe.
#: Every entry carries a "crash-capable" note in its fault-point
#: registration.
CRASH_CAPABLE_POINTS: dict[str, str] = {
    "checkpoint.write": "death before any checkpoint byte reaches disk",
    "checkpoint.replace": "death in the checkpoint's torn-write window",
    "checkpoint.read": "death at the start of a checkpoint RMW",
    "cdi.write": "death before a claim CDI spec publish",
    "devicestate.prepare": "death mid-prepare, after PrepareStarted",
    "durability.write": "death before any state-file byte reaches disk",
    "durability.replace": "death in any state file's torn-write window",
}

#: Torn-file variants (the byte-level injector). Each names a corruption
#: of the published checkpoint and the recovery the oracle demands.
TORN_VARIANTS = (
    "bak-recover",       # truncated main + good .bak + reboot → recover
    "garbage-main",      # garbage main, no .bak, reboot → reset + sweep
    "both-torn",         # main AND .bak garbage + reboot → reset + sweep
    "same-boot-refuse",  # garbage main, same boot id → LOUD refusal
)

_NEVER = 999999999  # nth hit that never arrives: counts hits, fires nothing


@dataclass
class CrashEnv:
    """One scenario run's world: a throwaway root directory plus whatever
    the scenario stashes (client, config, claims, last driver)."""

    root: str
    extras: dict[str, Any] = field(default_factory=dict)

    def __getitem__(self, key: str) -> Any:
        return self.extras[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self.extras[key] = value

    def get(self, key: str, default: Any = None) -> Any:
        return self.extras.get(key, default)


class Scenario:
    """One canonical recovery story. ``setup`` establishes fault-free
    pre-state; ``run`` is the crashable window (the fault plan is active
    only here); ``recover`` builds a fresh stack over the same disk state
    and replays; ``oracle`` appends human-readable violations to
    ``problems`` instead of raising, so one bad site cannot hide the
    rest."""

    name = ""
    #: run the byte-level torn-checkpoint legs against this scenario
    torn = False

    def setup(self, env: CrashEnv) -> None:  # pragma: no cover - interface
        pass

    def run(self, env: CrashEnv) -> None:
        raise NotImplementedError

    def recover(self, env: CrashEnv) -> None:
        raise NotImplementedError

    def oracle(self, env: CrashEnv, problems: list[str]) -> None:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# GPU-stack plumbing shared by the checkpoint-backed scenarios
# ---------------------------------------------------------------------------

def _gpu_env(root: str) -> CrashEnv:
    """A one-node GPU stack (the ``h100-8`` mock) over an on-disk state
    dir, with the boot id under crashlab's control via the alt-path file."""
    from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
    from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
    from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
        DriverConfig,
        GpuDriver,
    )
    from k8s_dra_driver_tpu_torch.gpulib import MockDeviceLib

    env = CrashEnv(root=root)
    client = FakeClient()
    client.create(new_object(
        "DeviceClass", "gpu.nvidia.com",
        spec={"selectors": [{"cel": {
            "expression": "device.attributes['type'] == 'gpu'"}}]}))
    boot_path = os.path.join(root, "boot_id")
    with open(boot_path, "w") as f:
        f.write("boot-a\n")
    cfg = DriverConfig(
        node_name="node-a",
        state_dir=os.path.join(root, "state"),
        cdi_root=os.path.join(root, "cdi"),
        env={"GPU_DRA_ALT_BOOT_ID_PATH": boot_path},
        retry_timeout=0.5,
    )
    env["client"] = client
    env["cfg"] = cfg
    env["boot_path"] = boot_path

    def new_driver() -> GpuDriver:
        drv = GpuDriver(client, cfg,
                        device_lib=MockDeviceLib("h100-8")).start()
        env["driver"] = drv
        return drv

    env["new_driver"] = new_driver
    return env


def _make_claim(env: CrashEnv, name: str, count: int = 1) -> dict:
    from k8s_dra_driver_tpu_torch.k8sclient.client import new_object

    return env["client"].create(new_object(
        "ResourceClaim", name, "default",
        api_version="resource.k8s.io/v1",
        spec={"devices": {"requests": [{
            "name": "gpu", "exactly": {
                "deviceClassName": "gpu.nvidia.com",
                "allocationMode": "ExactCount", "count": count}}]}}))


def _allocate(env: CrashEnv, claim: dict) -> dict:
    from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator

    return Allocator(env["client"]).allocate(claim, node="node-a")


def _ref(claim: dict):
    from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef

    return ClaimRef(uid=claim["metadata"]["uid"],
                    name=claim["metadata"]["name"],
                    namespace=claim["metadata"].get("namespace", ""))


def _end_state_clean(env: CrashEnv, driver, problems: list[str],
                     where: str) -> None:
    """The shared leak half of the oracle: after full replay + drain the
    checkpoint and the CDI root must both be empty."""
    left = driver.state.prepared_claims()
    if left:
        problems.append(
            f"{where}: {len(left)} claim(s) leaked in the checkpoint: "
            f"{sorted(left)}")
    specs = driver.cdi.list_claim_uids()
    if specs:
        problems.append(f"{where}: {len(specs)} CDI spec(s) leaked: {specs}")


class PrepareScenario(Scenario):
    """Two claims prepared; crash anywhere from plugin start through the
    second prepare. Recovery: a fresh plugin replays both prepares
    (idempotently — a second replay must return identical devices), then
    drains everything."""

    name = "prepare"
    torn = True

    def setup(self, env: CrashEnv) -> None:
        # A previous plugin life publishes the ResourceSlices (and the
        # initial checkpoint) the allocator needs; `run` then restarts.
        env["new_driver"]()
        env["claims"] = [
            _allocate(env, _make_claim(env, f"wl-{i}")) for i in (1, 2)]

    def run(self, env: CrashEnv) -> None:
        drv = env["new_driver"]()
        for claim in env["claims"]:
            drv.prepare_resource_claims([claim])

    def recover(self, env: CrashEnv) -> None:
        env["new_driver"]()

    def oracle(self, env: CrashEnv, problems: list[str]) -> None:
        drv = env["driver"]
        for claim in env["claims"]:
            uid = claim["metadata"]["uid"]
            r1 = drv.prepare_resource_claims([claim])[uid]
            if r1.error is not None:
                problems.append(f"replayed prepare of {uid} failed: "
                                f"{r1.error!r}")
                continue
            if drv.cdi.read_claim_spec(uid) is None:
                problems.append(f"prepared claim {uid} has no CDI spec")
            r2 = drv.prepare_resource_claims([claim])[uid]
            if r2.error is not None or r1.devices != r2.devices:
                problems.append(
                    f"replay of {uid} is not idempotent: "
                    f"{r1.devices} != {r2.devices} ({r2.error!r})")
        for claim in env["claims"]:
            uid = claim["metadata"]["uid"]
            err = drv.unprepare_resource_claims([_ref(claim)])[uid]
            if err is not None:
                problems.append(f"unprepare of {uid} failed: {err!r}")
        _end_state_clean(env, drv, problems, self.name)


class UnprepareScenario(Scenario):
    """Two prepared claims; crash anywhere in their unprepares. Recovery:
    a fresh plugin re-runs both unprepares — idempotent whether or not
    the crashed one committed."""

    name = "unprepare"

    def setup(self, env: CrashEnv) -> None:
        drv = env["new_driver"]()
        env["claims"] = [
            _allocate(env, _make_claim(env, f"wl-{i}")) for i in (1, 2)]
        for claim in env["claims"]:
            res = drv.prepare_resource_claims([claim])
            uid = claim["metadata"]["uid"]
            if res[uid].error is not None:
                raise RuntimeError(f"setup prepare failed: {res[uid].error!r}")

    def run(self, env: CrashEnv) -> None:
        drv = env["driver"]
        for claim in env["claims"]:
            drv.unprepare_resource_claims([_ref(claim)])

    def recover(self, env: CrashEnv) -> None:
        env["new_driver"]()

    def oracle(self, env: CrashEnv, problems: list[str]) -> None:
        drv = env["driver"]
        for claim in env["claims"]:
            uid = claim["metadata"]["uid"]
            err = drv.unprepare_resource_claims([_ref(claim)])[uid]
            if err is not None:
                problems.append(
                    f"replayed unprepare of {uid} failed: {err!r}")
        _end_state_clean(env, drv, problems, self.name)


class DrainTombstoneScenario(Scenario):
    """A prepared claim drained off the node; crash anywhere in the
    drain. Recovery: a replayed drain commits the tombstone; the SAME
    claim version must then be rejected (``StaleAbortedClaimError`` —
    re-preparing would re-enter the bad GPUs) while tombstone GC +
    unprepare end clean."""

    name = "drain_tombstone"

    def setup(self, env: CrashEnv) -> None:
        drv = env["new_driver"]()
        env["claims"] = [_allocate(env, _make_claim(env, "wl-drain"))]
        uid = env["claims"][0]["metadata"]["uid"]
        res = drv.prepare_resource_claims(env["claims"])
        if res[uid].error is not None:
            raise RuntimeError(f"setup prepare failed: {res[uid].error!r}")

    def run(self, env: CrashEnv) -> None:
        env["driver"].drain_claim(_ref(env["claims"][0]), reason="crashlab")

    def recover(self, env: CrashEnv) -> None:
        env["new_driver"]()

    def oracle(self, env: CrashEnv, problems: list[str]) -> None:
        from k8s_dra_driver_tpu_torch.pkg.errors import StaleAbortedClaimError
        from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.checkpoint import (
            STATE_PREPARE_ABORTED,
        )

        drv = env["driver"]
        claim = env["claims"][0]
        uid = claim["metadata"]["uid"]
        ref = _ref(claim)
        # Replay the drain: idempotent whether the crash landed before or
        # after the tombstone commit (False = already tombstoned).
        drv.drain_claim(ref, reason="crashlab-replay")
        pc = drv.state.prepared_claims().get(uid)
        if pc is None or pc.state != STATE_PREPARE_ABORTED:
            problems.append(
                f"drain replay left no tombstone for {uid} "
                f"(state={getattr(pc, 'state', None)!r})")
        if drv.cdi.read_claim_spec(uid) is not None:
            problems.append(f"drained claim {uid} still has a CDI spec")
        # Tombstone semantics: the drained claim VERSION must be refused.
        res = drv.prepare_resource_claims([claim])[uid]
        if not isinstance(res.error, StaleAbortedClaimError):
            problems.append(
                f"stale prepare of drained {uid} was not rejected "
                f"(error={res.error!r})")
        # GC the tombstone (kubelet unprepare pops it the same way).
        drv.state.delete_expired_aborted(now=float("inf"))
        drv.unprepare_resource_claims([ref])
        _end_state_clean(env, drv, problems, self.name)


class ReallocationScenario(Scenario):
    """A drained claim re-allocated onto a different GPU; crash anywhere
    in the overwriting prepare. Recovery: the REALLOCATED version (same
    uid, different results) must overwrite the tombstone and prepare
    cleanly — the self-healing rejoin path."""

    name = "reallocation"

    def setup(self, env: CrashEnv) -> None:
        drv = env["new_driver"]()
        claim = _allocate(env, _make_claim(env, "wl-move"))
        uid = claim["metadata"]["uid"]
        res = drv.prepare_resource_claims([claim])
        if res[uid].error is not None:
            raise RuntimeError(f"setup prepare failed: {res[uid].error!r}")
        if not drv.drain_claim(_ref(claim), reason="crashlab"):
            raise RuntimeError("setup drain did not tombstone")
        # Re-bind onto a different GPU: the reallocator's move, distilled
        # to its effect on the claim object. Deep-copy first — the live
        # checkpoint commit-cache holds references into the ORIGINAL
        # claim's result dicts, and a real reallocator writes a fresh
        # object through the API, never mutates the driver's aliases.
        moved = json.loads(json.dumps(claim))
        results = moved["status"]["allocation"]["devices"]["results"]
        old = results[0]["device"]
        names = sorted(c.canonical_name for c in drv.state.gpus)
        results[0]["device"] = next(n for n in names if n != old)
        env["client"].update_status(moved)
        env["claims"] = [moved]
        env["moved_to"] = results[0]["device"]

    def run(self, env: CrashEnv) -> None:
        env["driver"].prepare_resource_claims(env["claims"])

    def recover(self, env: CrashEnv) -> None:
        env["new_driver"]()

    def oracle(self, env: CrashEnv, problems: list[str]) -> None:
        from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.checkpoint import (
            STATE_PREPARE_COMPLETED,
        )

        drv = env["driver"]
        claim = env["claims"][0]
        uid = claim["metadata"]["uid"]
        res = drv.prepare_resource_claims([claim])[uid]
        if res.error is not None:
            problems.append(
                f"reallocated prepare of {uid} failed: {res.error!r}")
        pc = drv.state.prepared_claims().get(uid)
        if pc is None or pc.state != STATE_PREPARE_COMPLETED:
            problems.append(
                f"reallocated {uid} not PrepareCompleted "
                f"(state={getattr(pc, 'state', None)!r})")
        elif not any(r.get("device") == env["moved_to"]
                     for r in pc.results):
            problems.append(
                f"reallocated {uid} prepared on the wrong device: "
                f"{pc.results} (wanted {env['moved_to']})")
        drv.unprepare_resource_claims([_ref(claim)])
        _end_state_clean(env, drv, problems, self.name)


class FenceCleanupScenario(Scenario):
    """The partition-heal path: one checkpointed
    claim was deleted and one moved off-node while this plugin was
    fenced; crash anywhere in ``fence_cleanup_for``. Recovery: the
    cleanup re-runs (it raises on failure so the fence stands — the
    retry IS the contract) and must leave no stale prepared state."""

    name = "fence_cleanup"

    def setup(self, env: CrashEnv) -> None:
        drv = env["new_driver"]()
        claims = [_allocate(env, _make_claim(env, f"wl-{i}")) for i in (1, 2)]
        for claim in claims:
            uid = claim["metadata"]["uid"]
            res = drv.prepare_resource_claims([claim])
            if res[uid].error is not None:
                raise RuntimeError(
                    f"setup prepare failed: {res[uid].error!r}")
        client = env["client"]
        # Claim 1: deleted while we were partitioned.
        client.delete("ResourceClaim", claims[0]["metadata"]["name"],
                      "default")
        # Claim 2: the reallocator moved it to another node's pool.
        moved = client.get("ResourceClaim", claims[1]["metadata"]["name"],
                           "default")
        for r in moved["status"]["allocation"]["devices"]["results"]:
            r["pool"] = "node-b"
        client.update_status(moved)
        env["claims"] = claims

    def run(self, env: CrashEnv) -> None:
        from k8s_dra_driver_tpu_torch.pkg.nodelease import fence_cleanup_for

        fence_cleanup_for(env["driver"], env["client"])()

    def recover(self, env: CrashEnv) -> None:
        env["new_driver"]()

    def oracle(self, env: CrashEnv, problems: list[str]) -> None:
        from k8s_dra_driver_tpu_torch.pkg.nodelease import fence_cleanup_for

        drv = env["driver"]
        try:
            fence_cleanup_for(drv, env["client"])()
        except Exception as e:  # noqa: BLE001 — a failed retry is a verdict
            problems.append(f"fence cleanup replay failed: {e!r}")
        _end_state_clean(env, drv, problems, self.name)


class NodeEpochScenario(Scenario):
    """Epoch bump-and-persist (``nodelease.next_node_epoch``); crash in
    the epoch file's publish window. Recovery: the next start's epoch
    must still be strictly greater than every epoch a live process was
    ever handed — a torn epoch file may cost a number, never monotony."""

    name = "node_epoch"

    def setup(self, env: CrashEnv) -> None:
        env["returned"] = []
        env["state_dir"] = os.path.join(env.root, "state")

    def run(self, env: CrashEnv) -> None:
        from k8s_dra_driver_tpu_torch.pkg import nodelease

        for _ in range(2):
            epoch, _boot = nodelease.next_node_epoch(env["state_dir"])
            env["returned"].append(epoch)

    def recover(self, env: CrashEnv) -> None:
        from k8s_dra_driver_tpu_torch.pkg import nodelease

        env["recovered_epoch"] = nodelease.next_node_epoch(
            env["state_dir"])[0]

    def oracle(self, env: CrashEnv, problems: list[str]) -> None:
        seen = env["returned"]
        if any(b <= a for a, b in zip(seen, seen[1:])):
            problems.append(f"epochs not strictly increasing: {seen}")
        if seen and env["recovered_epoch"] <= max(seen):
            problems.append(
                f"post-restart epoch {env['recovered_epoch']} did not "
                f"advance past {max(seen)}")
        # The epoch file itself must be whole (or absent) — never torn.
        path = os.path.join(env["state_dir"], "node-epoch.json")
        if os.path.exists(path):
            try:
                with open(path) as f:
                    json.load(f)
            except ValueError as e:
                problems.append(f"epoch file torn on disk: {e}")


class IncidentBundleScenario(Scenario):
    """Flight-recorder bundle publishes (pkg/blackbox.py) with bounded
    retention; crash in any bundle's publish window. Recovery: every
    bundle on disk parses whole (a torn publish may cost a bundle, never
    a misparse), the reader serves them, and a fresh capture completes
    error-free."""

    name = "incident_bundle"

    def _fire_clear(self, rec, slo: str) -> None:
        rec.on_alert({"slo": slo, "severity": "page",
                      "transition": "fired"})
        rec.on_alert({"slo": slo, "severity": "page",
                      "transition": "cleared"})

    def setup(self, env: CrashEnv) -> None:
        env["state_dir"] = os.path.join(env.root, "state")
        os.makedirs(env["state_dir"], exist_ok=True)

    def run(self, env: CrashEnv) -> None:
        from k8s_dra_driver_tpu_torch.pkg.blackbox import FlightRecorder

        rec = FlightRecorder(env["state_dir"], retention=2)
        env["recorder"] = rec
        # Two full incident arcs: 4 publishes, the last evicting past
        # retention — crash sites cover first write through eviction.
        self._fire_clear(rec, "claim_ready_latency")
        self._fire_clear(rec, "prepare_errors")

    def recover(self, env: CrashEnv) -> None:
        from k8s_dra_driver_tpu_torch.pkg.blackbox import FlightRecorder

        env["recorder"] = FlightRecorder(env["state_dir"], retention=2)

    def oracle(self, env: CrashEnv, problems: list[str]) -> None:
        rec = env["recorder"]
        incidents = os.path.join(env["state_dir"], "incidents")
        names = sorted(n for n in os.listdir(incidents)
                       if n.endswith(".json")) if os.path.isdir(
                           incidents) else []
        for name in names:
            try:
                with open(os.path.join(incidents, name)) as f:
                    doc = json.load(f)
            except ValueError as e:
                problems.append(f"bundle {name} torn on disk: {e}")
                continue
            if "id" not in doc or "status" not in doc:
                problems.append(f"bundle {name} missing id/status")
                continue
            try:
                if rec.bundle(doc["id"]) is None:
                    problems.append(f"reader cannot load bundle {doc['id']}")
            except ValueError as e:
                problems.append(f"reader refused bundle {doc['id']}: {e}")
        # A fresh capture over the recovered directory completes cleanly.
        self._fire_clear(rec, "post_recovery")
        if rec.capture_errors:
            problems.append(
                f"post-recovery capture raised {rec.capture_errors} "
                "error(s)")
        if not any(n.endswith(".json") for n in os.listdir(incidents)):
            problems.append("post-recovery capture published no bundle")


SCENARIOS: dict[str, Scenario] = {
    s.name: s for s in (
        PrepareScenario(),
        UnprepareScenario(),
        DrainTombstoneScenario(),
        ReallocationScenario(),
        FenceCleanupScenario(),
        NodeEpochScenario(),
        IncidentBundleScenario(),
    )
}


# ---------------------------------------------------------------------------
# the explorer
# ---------------------------------------------------------------------------

def _build(scenario: Scenario, base_dir: Optional[str]) -> CrashEnv:
    root = tempfile.mkdtemp(prefix=f"crashlab-{scenario.name}-",
                            dir=base_dir)
    if scenario.name in ("node_epoch", "incident_bundle"):
        env = CrashEnv(root=root)
    else:
        env = _gpu_env(root)
    return env


def _norm(env: CrashEnv, text: str) -> str:
    """Scrub the run-unique temp root out of a verdict string so two
    runs of one seed compare equal."""
    return text.replace(env.root, "<root>")


def enumerate_sites(scenario: Scenario,
                    base_dir: Optional[str] = None) -> list[tuple[str, int]]:
    """The probe run: schedule a never-firing ``nth`` on every
    crash-capable point, run the scenario cleanly, and read the hit
    counters back as the site list. Pure in (registry, scenario)."""
    env = _build(scenario, base_dir)
    try:
        scenario.setup(env)
        plan = FaultPlan(seed=0)
        for point in sorted(CRASH_CAPABLE_POINTS):
            plan.add(point, f"nth:{_NEVER}")
        with faultpoints.injected(plan=plan):
            scenario.run(env)
        return [(point, hit)
                for point, count in plan.hits().items()
                for hit in range(1, count + 1)]
    finally:
        shutil.rmtree(env.root, ignore_errors=True)


def explore_site(scenario: Scenario, point: str, hit: int, seed: int,
                 base_dir: Optional[str] = None) -> dict[str, Any]:
    """Crash one site, restart, assert the oracle. Never raises: every
    failure mode is a verdict."""
    env = _build(scenario, base_dir)
    problems: list[str] = []
    crashed = False
    try:
        scenario.setup(env)
        plan = FaultPlan(seed=seed).add(point, f"crash-nth:{hit}")
        with faultpoints.injected(plan=plan):
            try:
                scenario.run(env)
            except FaultCrash:
                crashed = True
        if not crashed:
            problems.append(
                f"site ({point}, {hit}) never crashed — enumeration "
                "drifted from the scenario's path")
        try:
            scenario.recover(env)
            scenario.oracle(env, problems)
        except Exception as e:  # noqa: BLE001 — a crashing recovery IS
            # the verdict the oracle exists to report
            problems.append(
                f"recovery raised {type(e).__name__}: {e}")
    except Exception as e:  # noqa: BLE001 — setup/harness failure
        problems.append(f"harness failed: {type(e).__name__}: {e}")
    finally:
        shutil.rmtree(env.root, ignore_errors=True)
    return {"scenario": scenario.name, "point": point, "hit": hit,
            "crashed": crashed,
            "problems": [_norm(env, p) for p in problems]}


def inject_torn_checkpoint(env: CrashEnv, variant: str) -> None:
    """The byte-level injector: corrupt the published checkpoint the way
    a power loss mid-``os.replace`` can (name published before data),
    steer the ``.bak`` and the boot id per ``variant``."""
    # The live manager's own paths — no re-derived naming that could
    # silently drift from what bootstrap actually reads.
    mgr = env["driver"].state.checkpoints
    cp, bak = os.fspath(mgr.path), os.fspath(mgr.backup_path)
    with open(cp, "rb") as f:
        data = f.read()
    if variant == "bak-recover":
        # A good backup of the last publish (what the hard link holds),
        # then tear the main file mid-byte and reboot.
        shutil.copyfile(cp, bak)
        with open(cp, "wb") as f:
            f.write(data[:max(1, len(data) // 2)])
        with open(env["boot_path"], "w") as f:
            f.write("boot-b\n")
    elif variant == "garbage-main":
        try:
            os.unlink(bak)
        except FileNotFoundError:
            pass
        with open(cp, "wb") as f:
            f.write(b"\x00not json{{{")
        with open(env["boot_path"], "w") as f:
            f.write("boot-b\n")
    elif variant == "both-torn":
        with open(bak, "wb") as f:
            f.write(data[: max(1, len(data) // 3)] + b"\xff")
        with open(cp, "wb") as f:
            f.write(b"\x00not json{{{")
        with open(env["boot_path"], "w") as f:
            f.write("boot-b\n")
    elif variant == "same-boot-refuse":
        shutil.copyfile(cp, bak)
        with open(cp, "wb") as f:
            f.write(b"\x00not json{{{")
        # boot id unchanged: same-boot corruption, which the rename
        # protocol cannot produce — recovery must refuse loudly.
    else:
        raise ValueError(f"unknown torn variant {variant!r}")


def explore_torn(scenario: Scenario, variant: str,
                 base_dir: Optional[str] = None) -> dict[str, Any]:
    """Run the scenario cleanly, corrupt the checkpoint per ``variant``,
    restart, and assert the recovery matrix (pkg/durability.py)."""
    from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.checkpoint import (
        CorruptCheckpointError,
    )

    env = _build(scenario, base_dir)
    problems: list[str] = []
    try:
        scenario.setup(env)
        scenario.run(env)
        inject_torn_checkpoint(env, variant)
        if variant == "same-boot-refuse":
            try:
                env["new_driver"]()
                problems.append(
                    "same-boot corrupt checkpoint was silently accepted — "
                    "must refuse loudly (CorruptCheckpointError)")
            except CorruptCheckpointError:
                pass  # the loud refusal IS the correct recovery
        else:
            drv = env["new_driver"]()  # reboot: recover from .bak or reset
            left = drv.state.prepared_claims()
            if left:
                problems.append(
                    f"boot-id change did not discard prepared claims: "
                    f"{sorted(left)}")
            specs = drv.cdi.list_claim_uids()
            if specs:
                problems.append(
                    f"CDI specs survived the reboot discard/sweep: {specs}")
    except Exception as e:  # noqa: BLE001 — any raise here is a verdict
        problems.append(
            f"torn-file recovery raised {type(e).__name__}: {e}")
    finally:
        shutil.rmtree(env.root, ignore_errors=True)
    return {"scenario": scenario.name, "point": f"torn:{variant}", "hit": 0,
            "crashed": True, "problems": [_norm(env, p) for p in problems]}


def run_crashlab(
    scenarios: Optional[list[str]] = None,
    seed: int = 0,
    max_sites_per_scenario: int = 0,
    torn: bool = True,
    base_dir: Optional[str] = None,
) -> dict[str, Any]:
    """Explore the corpus. ``max_sites_per_scenario`` > 0 caps each
    scenario's site list (smoke slices) — skipped sites are COUNTED, so
    a capped run can never read as full coverage. Returns the verdict;
    ``verdict_log`` is sorted
    and temp-path-scrubbed: same seed + corpus ⇒ byte-identical."""
    t0 = time.monotonic()
    names = list(scenarios) if scenarios else sorted(SCENARIOS)
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        raise ValueError(f"unknown crashlab scenarios: {unknown} "
                         f"(known: {sorted(SCENARIOS)})")
    results: list[dict[str, Any]] = []
    per_scenario: dict[str, dict[str, Any]] = {}
    sites_enumerated = 0
    sites_skipped = 0
    crashed_points: set[str] = set()
    for name in names:
        scenario = SCENARIOS[name]
        sites = enumerate_sites(scenario, base_dir=base_dir)
        sites_enumerated += len(sites)
        take = sites[:max_sites_per_scenario] if max_sites_per_scenario \
            else sites
        sites_skipped += len(sites) - len(take)
        scen_results = [
            explore_site(scenario, point, hit, seed, base_dir=base_dir)
            for point, hit in take]
        crashed_points.update(p for p, _ in take)
        torn_results: list[dict[str, Any]] = []
        if torn and scenario.torn:
            torn_results = [explore_torn(scenario, v, base_dir=base_dir)
                            for v in TORN_VARIANTS]
        results.extend(scen_results + torn_results)
        per_scenario[name] = {
            "sites": len(sites),
            "explored": len(take),
            "torn_variants": len(torn_results),
            "violations": sum(1 for r in scen_results + torn_results
                              if r["problems"]),
        }
    violations = [f"{r['scenario']}|{r['point']}|{r['hit']}: {p}"
                  for r in results for p in r["problems"]]
    verdict_log = sorted(
        f"{r['scenario']}|{r['point']}|{r['hit']}|"
        + ("ok" if not r["problems"] else "; ".join(r["problems"]))
        for r in results)
    if set(names) == set(SCENARIOS) and not max_sites_per_scenario:
        uncrashed = sorted(set(CRASH_CAPABLE_POINTS) - crashed_points)
    else:
        # Whole-universe coverage is only meaningful on full-corpus
        # runs (however the corpus was spelled); a slice reports its
        # own coverage via sites_skipped.
        uncrashed = []
    return {
        "seed": seed,
        "scenarios": names,
        "sites_enumerated": sites_enumerated,
        "sites_explored": sites_enumerated - sites_skipped,
        "sites_skipped": sites_skipped,
        "torn_explored": sum(s["torn_variants"]
                             for s in per_scenario.values()),
        "oracle_violations": sorted(violations),
        "uncrashed_capable_points": uncrashed,
        "coverage_ok": sites_skipped == 0 and not uncrashed,
        "verdict_log": verdict_log,
        "per_scenario": per_scenario,
        "wall_s": round(time.monotonic() - t0, 3),
    }


def run_crash_smoke(seed: int = 0,
                    base_dir: Optional[str] = None) -> dict[str, Any]:
    """The seconds-scale slice: three scenarios covering
    the prepare path, the tombstone contract, and the shared publish
    helper, plus every torn-file variant — uncapped within the slice so
    its own coverage count is real."""
    return run_crashlab(
        scenarios=["prepare", "drain_tombstone", "node_epoch"],
        seed=seed, torn=True, base_dir=base_dir)
