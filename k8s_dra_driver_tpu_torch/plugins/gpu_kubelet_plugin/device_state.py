"""Transactional prepare/unprepare of GPU claims around the checkpoint.

Copied from the JAX package's ``plugins/tpu_kubelet_plugin/device_state.py``
and cut to whole GPUs (MIG partitions and VFIO passthrough wait), its drain
side included: a drained claim leaves a ``PrepareAborted`` tombstone. As there,
the analogue of the reference's ``cmd/gpu-kubelet-plugin/device_state.go``
(``Prepare`` :289, ``Unprepare`` :486, ``prepareDevices`` :818,
``GetOpaqueDeviceConfigs`` :1410, ``validateNoOverlappingPreparedDevices``
:1484): every Prepare is a PrepareStarted → (device prep + CDI write) →
PrepareCompleted transaction, idempotent on replay, with rollback of
partially prepared claims and boot-id invalidation of stale state.

Concurrency model (docs/performance.md) — this deliberately DIVERGES from
the reference, which holds one mutex plus the node flock across the whole
prepare and therefore serializes every claim behind every other claim's
fsyncs:

- same-claim operations serialize on a per-claim in-flight lock
  (:class:`pkg.inflight.ClaimFlightTable`); disjoint claims overlap.
- cross-claim invariants (idempotency on replay, the no-overlapping-
  devices validator, the PrepareStarted registration) are enforced inside
  ONE checkpoint transaction (``CheckpointManager.transact``), whose
  group-commit batches concurrent claims' RMWs into a single
  flock-guarded marshal+fsync+rename.
- the hardware registry is an immutable snapshot (:class:`_Enumeration`)
  swapped atomically by ``refresh_enumeration`` under the short state
  lock, so a prepare sees one consistent enumeration end to end without
  holding any lock while touching devices.

Lock hierarchy: claim lock → checkpoint commit locks → flock; ``_mu`` is never held while
acquiring a claim lock or a checkpoint lock.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from k8s_dra_driver_tpu_torch.api.configs import (
    ConfigError,
    GpuConfig,
    strict_decode,
)
from k8s_dra_driver_tpu_torch.cdi.spec import (
    CDIDevice,
    CDIHandler,
    claim_edits_for,
)
from k8s_dra_driver_tpu_torch.gpulib.chip import GpuInfo, NodeGpuInfo
from k8s_dra_driver_tpu_torch.gpulib.device_lib import (
    DeviceLib,
    enforce_fabric_consistency,
)
from k8s_dra_driver_tpu_torch.k8sclient.client import Obj
from k8s_dra_driver_tpu_torch.kubeletplugin.types import (
    ClaimRef,
    PreparedDeviceRef,
    claim_allocation_configs,
    claim_allocation_results,
    claim_uid,
)
from k8s_dra_driver_tpu_torch.pkg import faultpoints, sanitizer, tracing
from k8s_dra_driver_tpu_torch.pkg.errors import (
    PermanentError,
    StaleAbortedClaimError,
)
from k8s_dra_driver_tpu_torch.pkg.featuregates import (
    CRASH_ON_NVLINK_FABRIC_ERRORS,
    FeatureGates,
    new_feature_gates,
)
from k8s_dra_driver_tpu_torch.pkg.flock import Flock
from k8s_dra_driver_tpu_torch.pkg.inflight import ClaimFlightTable
from k8s_dra_driver_tpu_torch.pkg.metrics import DRAMetrics
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.checkpoint import (
    STATE_PREPARE_ABORTED,
    STATE_PREPARE_COMPLETED,
    STATE_PREPARE_STARTED,
    Checkpoint,
    CheckpointError,
    CheckpointManager,
    PreparedClaimCP,
    bootstrap_checkpoint,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.prepared import PreparedDevice

logger = logging.getLogger(__name__)

DRIVER_NAME = "gpu.nvidia.com"

# How long a drained claim's PrepareAborted tombstone is kept (the CD
# plugin's PREPARE_ABORTED_TTL, generalized to the GPU plugin by the drain
# path): long enough to reject a stale kubelet prepare retry of the drained
# claim version.
PREPARE_ABORTED_TTL = 10 * 60.0

# Fault point inside the device-preparation window: after the claim's
# PrepareStarted record is durable, before any device side effect. A
# latency schedule here is how the concurrency tests hold a prepare open
# (docs/fault-injection.md).
FP_PREPARE = faultpoints.register(
    "devicestate.prepare",
    "device preparation fails/stalls after the PrepareStarted record")


class OverlapError(RuntimeError):
    """Another live claim holds (some of) the requested physical devices.

    Deliberately RETRYABLE, not permanent: with concurrent claim
    lifecycles there is a legitimate transient flavor — a claim whose
    unprepare has undone its device state but not yet dropped its
    checkpoint record (the restore-before-drop contract) briefly clashes
    with a successor claim allocated the same GPUs after a force-delete.
    The retry heals that within the workqueue budget; a GENUINE overlap
    (scheduler race, force-delete artifact) keeps failing every retry and
    surfaces after the budget, still loudly."""


@dataclass(frozen=True)
class _Enumeration:
    """One immutable, internally consistent view of the node's GPUs.

    Prepares read ``self._enum`` once and use that snapshot throughout, so
    a concurrent ``refresh_enumeration`` can never hand half a prepare the
    old GPU registry and the other half the new one."""

    node_info: NodeGpuInfo
    gpus: tuple[GpuInfo, ...]
    gpus_by_name: dict[str, GpuInfo]


class DeviceState:
    """Owns the checkpoint, the CDI handler, and the allocatable-device
    registry for one node. Checkpoint mutations are atomic group-committed
    transactions guarded by the node-global flock (more than one plugin
    process may run during upgrades); same-claim operations additionally
    serialize in-process on the claim's in-flight lock."""

    def __init__(
        self,
        device_lib: DeviceLib,
        cdi: CDIHandler,
        checkpoint_path: str,
        lock_path: str,
        node_boot_id: str = "",
        pool_name: str = "",
        driver_name: str = DRIVER_NAME,
        gates: Optional[FeatureGates] = None,
        metrics: Optional[DRAMetrics] = None,
        aborted_ttl: float = PREPARE_ABORTED_TTL,
        clock: Callable[[], float] = time.time,
    ):
        self.device_lib = device_lib
        self.aborted_ttl = aborted_ttl
        self.clock = clock
        self.cdi = cdi
        self.lock = Flock(lock_path)
        self.metrics = metrics
        self.checkpoints = CheckpointManager(
            checkpoint_path, flock=self.lock, on_batch=self._observe_batch)
        self.node_boot_id = node_boot_id
        self.pool_name = pool_name
        self.driver_name = driver_name
        self.gates = gates or new_feature_gates()
        # Short shared-state lock: guards the enumeration snapshot swap.
        # Never held across a prepare.
        self._mu = sanitizer.new_lock("DeviceState._mu")
        self._flights = ClaimFlightTable(
            "DeviceState", on_change=self._set_inflight_gauge,
            lock_dir=os.path.join(os.path.dirname(lock_path) or ".",
                                  "claim-locks"))
        self._enum = self._enumerate()
        self._bootstrap_checkpoint()

    # -- enumeration snapshot ------------------------------------------------

    def _enumerate(self) -> _Enumeration:
        gpus = tuple(self.device_lib.enumerate_gpus())
        enum = _Enumeration(
            node_info=self.device_lib.node_info(),
            gpus=gpus,
            gpus_by_name=sanitizer.track_state(
                {g.canonical_name: g for g in gpus},
                "DeviceState.enum.gpus_by_name"),
        )
        # Strict-vs-lenient node agreement (nvlib.go:209-330): a node whose
        # GPUs disagree must not be published under
        # CrashOnNVLinkFabricErrors.
        enforce_fabric_consistency(
            list(enum.gpus), strict=self.gates.enabled(CRASH_ON_NVLINK_FABRIC_ERRORS))
        return enum

    # Registry views (tests, bench, publication read these): one snapshot
    # attribute read — always internally consistent, possibly one refresh
    # stale, exactly like a prepare that finished just before the refresh.
    @property
    def node_info(self) -> NodeGpuInfo:
        return self._enum.node_info

    @property
    def gpus(self) -> list[GpuInfo]:
        return list(self._enum.gpus)

    def refresh_enumeration(self) -> None:
        """Re-walk the hardware (long-lived process observing hotplug /
        health changes) and swap in a fresh snapshot. In-flight prepares
        keep the snapshot they started with."""
        with self._mu:
            if hasattr(self.device_lib, "refresh"):
                self.device_lib.refresh()
            self._enum = self._enumerate()

    # -- metrics hooks -------------------------------------------------------

    def _set_inflight_gauge(self, n: int) -> None:
        if self.metrics is not None:
            self.metrics.prepare_inflight.set(n, driver=self.driver_name)

    def _observe_batch(self, size: int) -> None:
        if self.metrics is not None:
            self.metrics.checkpoint_batch_size.observe(
                size, driver=self.driver_name)

    # -- startup ------------------------------------------------------------

    def _bootstrap_checkpoint(self) -> None:
        """Boot-id invalidation via the shared helper; on a reboot the only
        artifact to heal per claim is its CDI spec."""
        with self.lock.held(timeout=10.0):
            bootstrap_checkpoint(
                self.checkpoints, self.node_boot_id,
                on_discard=lambda uid, pc: self.cdi.delete_claim_spec_file(uid))

    def sweep_unknown_claim_artifacts(self) -> list[str]:
        """Startup sweep (the DestroyUnknownMIGDevices analogue,
        device_state.go:448): delete CDI spec files not backed by a
        checkpointed claim. Whole-GPU claims create no kernel objects, so
        stray CDI files are the only artifacts to heal."""
        with self.lock.held(timeout=10.0):
            cp = self.checkpoints.read()
            known = set(cp.prepared_claims)
            removed = list(self.cdi.sweep_invalid_spec_files())
            for uid in self.cdi.list_claim_uids():
                if uid not in known:
                    self.cdi.delete_claim_spec_file(uid)
                    removed.append(uid)
            if removed:
                logger.info("swept %d unknown claim CDI specs: %s",
                            len(removed), removed)
            return removed

    # -- introspection used by GC and tests ---------------------------------

    def prepared_claims(self) -> dict[str, PreparedClaimCP]:
        with self.lock.held(timeout=10.0):
            return self.checkpoints.read().prepared_claims

    def prepared_claims_nolock(self) -> dict[str, PreparedClaimCP]:
        """Flock-free checkpoint read for liveness probes and gauges.

        Checkpoint writes are atomic (tmp + ``os.replace``), so an unlocked
        read always sees a complete, consistent snapshot — possibly one write
        stale, which is fine for "is my state readable" health semantics. The
        locked :meth:`prepared_claims` can block up to 10 s behind an ongoing
        commit, which would starve a 5 s kubelet probe deadline under load."""
        return self.checkpoints.read().prepared_claims

    # -- prepare ------------------------------------------------------------

    def prepare(self, claim: Obj) -> list[PreparedDeviceRef]:
        uid = claim_uid(claim)
        if not uid:
            raise PermanentError("claim has no uid")
        t0 = time.monotonic()
        # Stitches into the claim's propagated trace (or the caller's
        # active span); the checkpoint/CDI child spans below attribute the
        # phase latency, and the phase.* span events carry the intra-span
        # timings a trace (and an incident bundle) can attribute — log
        # lines cannot (docs/observability.md).
        with tracing.span_for_object(
                "prepare", claim,
                attributes={"driver": self.driver_name, "claim": uid}) as sp:
            with self._flights.claim(uid):
                sp.add_event("phase.serialize",
                             {"wait_s": round(time.monotonic() - t0, 6)})
                return self._prepare_inflight(uid, claim)

    def _prepare_inflight(self, uid: str,
                          claim: Obj) -> list[PreparedDeviceRef]:
        enum = self._enum
        results = self._own_results(claim)

        # Idempotent-replay fast path: a completed claim re-prepared (the
        # kubelet replays every running pod's claims on restart) must not
        # pay a checkpoint WRITE — one cached single-key read answers it.
        # The registration transaction below re-checks atomically.
        cur = self.checkpoints.read_cached().prepared_claims.get(uid)
        if cur is not None and cur.state == STATE_PREPARE_COMPLETED:
            logger.debug("prepare noop: claim %s already PrepareCompleted", uid)
            return self._refs_from_checkpoint(uid, cur)

        # Registration transaction: the idempotency check, the overlap
        # validation, and the PrepareStarted record are ONE atomic
        # checkpoint mutation, so two concurrent prepares racing for the
        # same physical GPUs cannot both pass validation — whichever
        # lands second in the commit sequence sees the first's record
        # (validate before mutate: the transact contract).
        def register(c: Checkpoint, overwrite_started: bool):
            cur = c.prepared_claims.get(uid)
            if cur is not None and cur.state == STATE_PREPARE_COMPLETED:
                # Prepare may be invoked more than once per claim; actual
                # device preparation must happen at most once.
                return "completed", cur
            if not results:
                raise PermanentError(
                    f"claim {uid} has no allocation results for driver "
                    f"{self.driver_name}")
            if (cur is not None and cur.state == STATE_PREPARE_ABORTED
                    and cur.results == results):
                # A retry of the exact claim version that was drained off a
                # tainted device (or rolled back): re-preparing would put it
                # straight back onto the bad GPUs. A RE-ALLOCATED claim
                # (same uid, different results) falls through and overwrites
                # the tombstone — that is the self-healing rejoin path.
                # The distinct type lets the claim watcher resolve the
                # same-device-reallocation case (docs/self-healing.md).
                raise StaleAbortedClaimError(
                    f"stale prepare for claim {uid}: prepare was already "
                    "aborted (drained)")
            if (cur is not None and cur.state == STATE_PREPARE_STARTED
                    and not overwrite_started):
                # A previous attempt died mid-prepare: the caller rolls
                # back outside the transaction before re-registering
                # (device_state.go:332-337).
                return "rollback", cur
            self._validate_no_overlap(c, uid, results, enum)
            c.prepared_claims[uid] = PreparedClaimCP(
                state=STATE_PREPARE_STARTED,
                name=claim.get("metadata", {}).get("name", ""),
                namespace=claim.get("metadata", {}).get("namespace", ""),
                results=results,
            )
            return "registered", None

        outcome, existing = self.checkpoints.transact(
            lambda c: register(c, False))
        if outcome == "completed":
            logger.debug("prepare noop: claim %s already PrepareCompleted", uid)
            return self._refs_from_checkpoint(uid, existing)
        if outcome == "rollback":
            logger.info("claim %s in PrepareStarted: rolling back partial "
                        "prepare before retry", uid)
            self._rollback_partial(uid, existing)
            outcome, existing = self.checkpoints.transact(
                lambda c: register(c, True))
            if outcome == "completed":
                return self._refs_from_checkpoint(uid, existing)

        faultpoints.maybe_fail(FP_PREPARE)
        span = tracing.current_span() or tracing.NOOP_SPAN
        tprep0 = time.monotonic()
        prepared = self._prepare_devices(claim, results, enum)
        span.add_event("phase.core",
                       {"s": round(time.monotonic() - tprep0, 6)})

        tcdi0 = time.monotonic()
        claim_edits = self._claim_edits(prepared, enum)
        cdi_devices = [
            CDIDevice(
                name=self.cdi.claim_device_name(uid, pd.device),
                device_nodes=pd.device_nodes,
                env=pd.env,
                mounts=pd.mounts,
            )
            for pd in prepared
        ]
        self.cdi.create_claim_spec_file(uid, cdi_devices, claim_edits=claim_edits)
        span.add_event("phase.cdi_spec",
                       {"s": round(time.monotonic() - tcdi0, 6)})

        def complete(c: Checkpoint) -> None:
            pc = c.prepared_claims.get(uid)
            if pc is None:
                # Validate-before-mutate: the record vanished (external
                # actor); retryable — the workqueue replays the prepare.
                raise CheckpointError(
                    f"claim {uid} vanished from checkpoint mid-prepare")
            pc.state = STATE_PREPARE_COMPLETED
            pc.prepared_devices = [pd.to_dict() for pd in prepared]

        self.checkpoints.transact(complete)
        return [pd.to_ref(self.cdi.qualified_id(pd.cdi_device_name))
                for pd in prepared]

    def _own_results(self, claim: Obj) -> list[dict[str, Any]]:
        return [r for r in claim_allocation_results(claim)
                if r.get("driver") == self.driver_name]

    @staticmethod
    def _device_phys_ids(name: str, enum: _Enumeration) -> set[str]:
        """Physical identities behind a DRA device name: ``gpu:<index>``
        plus ``pci:<bdf>`` when known. Unknown names map to empty
        (cross-driver results are filtered out before this)."""
        g = enum.gpus_by_name.get(name)
        if g is None:
            return set()
        out = {f"gpu:{g.index}"}
        if g.pci_address:
            out.add(f"pci:{g.pci_address}")
        return out

    @staticmethod
    def _held_phys_ids(pc: PreparedClaimCP) -> set[str]:
        """Identities a checkpointed claim holds, from prepare-time records
        (re-deriving from live enumeration would silently drop a claim's
        GPUs once one dies, disabling the overlap check). The records keep
        the checkpoint format's ``chipIndices`` key for the GPU index."""
        held: set[str] = set()
        for d in pc.prepared_devices:
            for i in d.get("chipIndices") or []:
                held.add(f"gpu:{i}")
        return held

    def _validate_no_overlap(self, cp: Checkpoint, uid: str,
                             results: list[dict[str, Any]],
                             enum: _Enumeration) -> None:
        """The same PHYSICAL GPU prepared under two different claims is a
        scheduler race or force-delete artifact; fail loudly
        (validateNoOverlappingPreparedDevices, device_state.go:1484).
        Comparison is at physical-identity granularity (GPU index / PCI
        BDF). Runs inside the registration transaction, so concurrent
        prepares validate against each other's records."""
        wanted: set[str] = set()
        for r in results:
            wanted |= self._device_phys_ids(r.get("device", ""), enum)
        for other_uid, pc in cp.prepared_claims.items():
            if other_uid == uid or pc.state == STATE_PREPARE_ABORTED:
                # Aborted tombstones hold no devices (drain released them);
                # counting their prepare-time records would block the
                # successor claim from the freed GPUs.
                continue
            held = self._held_phys_ids(pc)
            if not held:
                for r in pc.results:
                    held |= self._device_phys_ids(r.get("device", ""), enum)
            clash = wanted & held
            if clash:
                raise OverlapError(
                    f"devices {sorted(clash)} already prepared for claim "
                    f"{other_uid}; refusing overlapping prepare")

    def _rollback_partial(self, uid: str, pc: PreparedClaimCP) -> None:
        """Undo a partially executed prepare: whole-GPU prepares create no
        device state, so the CDI spec is the only artifact
        (unpreparePartiallyPrepairedClaim, device_state.go:612-700)."""
        self.cdi.delete_claim_spec_file(uid)

    # -- config resolution (GetOpaqueDeviceConfigs, device_state.go:1410) ----

    def _configs_for(self, claim: Obj, request: str) -> list[Any]:
        """Decoded opaque configs applying to ``request``, class configs
        first then claim configs (later entries take precedence when
        applied). Prepare always decodes strictly — both class and claim
        configs are fresh admin/user input here; the non-strict decoder is
        reserved for replaying configs persisted by older versions."""
        out = []
        for entry in claim_allocation_configs(claim):
            reqs = entry.get("requests") or []
            if reqs and request not in reqs:
                continue
            opaque = entry.get("opaque") or {}
            if opaque.get("driver") != self.driver_name:
                continue
            params = opaque.get("parameters") or {}
            try:
                out.append(strict_decode(params))
            except ConfigError as e:
                raise PermanentError(f"invalid opaque config for request "
                                     f"{request!r}: {e}") from e
        return out

    # -- device preparation --------------------------------------------------

    def _prepare_devices(self, claim: Obj, results: list[dict[str, Any]],
                         enum: _Enumeration) -> list[PreparedDevice]:
        uid = claim_uid(claim)
        prepared: list[PreparedDevice] = []
        for r in results:
            name = r.get("device", "")
            if name not in enum.gpus_by_name:
                raise PermanentError(f"allocated device {name!r} is not an "
                                     f"allocatable device on this node")
            configs = self._configs_for(claim, r.get("request", ""))
            prepared.append(self._prepare_gpu(uid, r, configs, enum))
        return prepared

    def _prepare_gpu(self, uid: str, result: dict[str, Any],
                     configs: list[Any],
                     enum: _Enumeration) -> PreparedDevice:
        """One whole GPU: its ``/dev/nvidia<minor>`` node and the driver's
        control nodes (the per-device edits of :func:`claim_edits_for`),
        plus the env of the claim's GpuConfigs, later ones winning."""
        name = result["device"]
        gpu = enum.gpus_by_name[name]
        env: dict[str, str] = {}
        for cfg in configs:
            if isinstance(cfg, GpuConfig):
                env.update(cfg.env)
        (edits,), _ = claim_edits_for([gpu.index], [gpu.minor], [gpu.uuid])
        return PreparedDevice(
            device=name,
            requests=[result.get("request", "")],
            pool=self.pool_name,
            cdi_device_name=self.cdi.claim_device_name(uid, name),
            device_nodes=list(edits.device_nodes),
            env=env,
            chip_indices=[gpu.index],
        )

    @staticmethod
    def _claim_edits(prepared: list[PreparedDevice],
                     enum: _Enumeration) -> CDIDevice:
        """Claim-wide visibility: ``CUDA_VISIBLE_DEVICES`` and
        ``NVIDIA_VISIBLE_DEVICES`` over the union of the claim's GPUs, by
        UUID (:func:`claim_edits_for`), in node index order."""
        gpus = sorted({enum.gpus_by_name[pd.device].index:
                       enum.gpus_by_name[pd.device] for pd in prepared}.items())
        _, claim_edits = claim_edits_for(
            [g.index for _, g in gpus], [g.minor for _, g in gpus],
            [g.uuid for _, g in gpus])
        return claim_edits

    def _refs_from_checkpoint(self, uid: str,
                              pc: PreparedClaimCP) -> list[PreparedDeviceRef]:
        out = []
        for d in pc.prepared_devices:
            pd = PreparedDevice.from_dict(d)
            out.append(pd.to_ref(self.cdi.qualified_id(pd.cdi_device_name)))
        return out

    # -- unprepare ----------------------------------------------------------

    def unprepare(self, ref: ClaimRef) -> None:
        with self._flights.claim(ref.uid, unlink_on_exit=True):
            cp = self.checkpoints.read_cached()
            pc = cp.prepared_claims.get(ref.uid)
            if pc is None:
                # Never prepared or already unprepared — Prepare+checkpoint
                # are transactional, so absence means nothing to undo.
                logger.debug("unprepare noop: claim %s not in checkpoint", ref.uid)
                return
            if pc.state == STATE_PREPARE_ABORTED:
                # A drained claim being unprepared by the kubelet (or by the
                # claim watcher before re-preparing its new allocation): the
                # devices were already restored at drain time, so the
                # tombstone's work is done — drop it.
                logger.debug("unprepare: dropping PrepareAborted tombstone "
                             "for claim %s", ref.uid)
                self.checkpoints.transact(
                    lambda c: c.prepared_claims.pop(ref.uid, None))
                return
            # Undo BEFORE dropping the record: a failed delete leaves the
            # claim checkpointed so the kubelet retries unprepare.
            self.cdi.delete_claim_spec_file(ref.uid)
            self.checkpoints.transact(
                lambda c: c.prepared_claims.pop(ref.uid, None))

    # -- drain (self-healing remediation, docs/self-healing.md) --------------

    def drain(self, ref: ClaimRef, reason: str = "") -> bool:
        """Gracefully evict one prepared claim from this node: undo its
        device state exactly like :meth:`unprepare`, but leave a
        ``PrepareAborted`` tombstone instead of dropping the record, so a
        stale kubelet prepare retry of the SAME claim version is rejected
        (the bad GPU must not be re-entered) while a RE-ALLOCATED version
        (different results) overwrites the tombstone and prepares normally.

        Serializes on the claim's flight lock — a drain landing while the
        claim's prepare is still in flight waits for it to finish and then
        unwinds the completed state. Returns whether anything was drained;
        crash-safe: a crash between the CDI delete and the tombstone commit
        leaves the claim checkpointed, so a replayed drain re-runs the
        (idempotent) delete and commits the tombstone."""
        with self._flights.claim(ref.uid):
            cp = self.checkpoints.read_cached()
            pc = cp.prepared_claims.get(ref.uid)
            if pc is None or pc.state == STATE_PREPARE_ABORTED:
                return False
            self.cdi.delete_claim_spec_file(ref.uid)
            expiry = self.clock() + self.aborted_ttl

            def mark(c: Checkpoint) -> bool:
                entry = c.prepared_claims.get(ref.uid)
                if entry is None or entry.state == STATE_PREPARE_ABORTED:
                    return False
                entry.state = STATE_PREPARE_ABORTED
                entry.prepared_devices = []
                entry.aborted_expiry = expiry
                return True

            drained = bool(self.checkpoints.transact(mark))
            if drained:
                logger.info("drained claim %s off this node%s", ref.uid,
                            f" ({reason})" if reason else "")
            return drained

    def delete_expired_aborted(self, now: Optional[float] = None) -> list[str]:
        """Drop expired PrepareAborted tombstones (the CD plugin's GC,
        generalized here for drained claims). One atomic transaction; a
        read-only pre-check keeps the periodic sweep from publishing a
        checkpoint when there is nothing to drop."""
        now = self.clock() if now is None else now

        def expired_in(claims: dict[str, PreparedClaimCP]) -> list[str]:
            return [
                uid for uid, pc in claims.items()
                if pc.state == STATE_PREPARE_ABORTED
                and (pc.aborted_expiry == 0.0 or now >= pc.aborted_expiry)
            ]

        if not expired_in(self.checkpoints.read().prepared_claims):
            return []

        def drop(c: Checkpoint) -> list[str]:
            expired = expired_in(c.prepared_claims)
            for uid in expired:
                c.prepared_claims.pop(uid, None)
            return expired

        expired = self.checkpoints.transact(drop)
        if expired:
            logger.info("expired %d PrepareAborted tombstones: %s",
                        len(expired), expired)
        return expired

    def adopt_boot_id(self, new_id: str) -> None:
        """Record a repair-simulated reboot (docs/self-healing.md): the
        checkpoint's boot id moves WITH the live process, so a later real
        restart does not read the flipped file as a second reboot and
        discard claims prepared after the rejoin."""
        if not new_id or new_id == self.node_boot_id:
            return

        def set_id(c: Checkpoint) -> None:
            c.node_boot_id = new_id

        self.checkpoints.transact(set_id)
        self.node_boot_id = new_id

    def claims_holding_device(self, device: str) -> list[ClaimRef]:
        """Checkpointed claims whose prepared state covers ``device`` —
        the drain controller's work list when that device is tainted.
        Comparison is at physical-identity granularity (the overlap
        validator's currency). A vanished GPU has no enumeration entry;
        its name still encodes the GPU index, which is exactly what the
        prepare-time records hold."""
        enum = self._enum
        want = self._device_phys_ids(device, enum)
        if not want and device.startswith("gpu-"):
            try:
                want = {f"gpu:{int(device.split('-')[1])}"}
            except (ValueError, IndexError):
                want = set()
        if not want:
            return []
        out: list[ClaimRef] = []
        try:
            claims = self.prepared_claims_nolock()
        except Exception:  # noqa: BLE001 — unreadable state already fails
            # requests loudly elsewhere; the drain retries next poll.
            return []
        for uid, pc in claims.items():
            if pc.state == STATE_PREPARE_ABORTED:
                continue
            held = self._held_phys_ids(pc)
            if not held:
                for r in pc.results:
                    held |= self._device_phys_ids(r.get("device", ""), enum)
            if not held and any(r.get("device", "") == device
                                for r in pc.results):
                held = set(want)
            if want & held:
                out.append(ClaimRef(uid=uid, name=pc.name,
                                    namespace=pc.namespace))
        return sorted(out, key=lambda r: r.uid)

    def claim_device_count(self, uid: str) -> int:
        """How many physical GPUs a prepared claim holds — the drain
        controller's priority key (docs/self-healing.md, "Drain
        ordering"): small claims vacate a tainted device before
        multi-GPU ones. 0 for unknown/unreadable claims (sorts first:
        nothing to evict)."""
        try:
            pc = self.prepared_claims_nolock().get(uid)
        except Exception:  # noqa: BLE001 — unreadable state already
            # fails requests loudly elsewhere; ordering degrades to uid.
            return 0
        if pc is None:
            return 0
        held = self._held_phys_ids(pc)
        if held:
            return len(held)
        enum = self._enum
        for r in pc.results:
            held |= self._device_phys_ids(r.get("device", ""), enum)
        if held:
            return len({h for h in held if h.startswith("gpu:")})
        return max(len(pc.prepared_devices), len(pc.results))
