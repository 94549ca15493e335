"""Transactional prepare/unprepare of GPU claims around the checkpoint.

Copied from the JAX package's ``plugins/tpu_kubelet_plugin/device_state.py``,
its drain side included: a drained claim leaves a ``PrepareAborted``
tombstone. Where the JAX package prepares a subslice, this one prepares a MIG
device, creating the instance at prepare (DynamicMIG) and destroying it at
unprepare, drain and rollback; a whole GPU with a ``VfioDeviceConfig``, or a
published vfio-bound GPU, is prepared for passthrough as there. Physical
identity, the overlap check's currency, is a (GPU, memory slice) pair: two
disjoint MIG devices of one GPU do not overlap, a MIG device and its whole
GPU do. As there, the analogue of the reference's
``cmd/gpu-kubelet-plugin/device_state.go`` (``Prepare`` :289,
``Unprepare`` :486, ``prepareDevices`` :818, ``GetOpaqueDeviceConfigs``
:1410, ``validateNoOverlappingPreparedDevices`` :1484): every Prepare is a PrepareStarted → (device prep + CDI write) →
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

Lock hierarchy: claim lock → DeviceState._mu (vfio lazy-init only) and
claim lock → checkpoint commit locks → flock; ``_mu`` is never held while
acquiring a claim lock or a checkpoint lock.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from k8s_dra_driver_tpu_torch.api.configs import (
    IOMMU_IOMMUFD,
    IOMMU_LEGACY,
    ConfigError,
    GpuConfig,
    MigDeviceConfig,
    VfioDeviceConfig,
    strict_decode,
)
from k8s_dra_driver_tpu_torch.cdi.spec import (
    CDIDevice,
    CDIHandler,
    claim_edits_for,
    claim_visibility_edits,
    mig_device_edits,
)
from k8s_dra_driver_tpu_torch.gpulib.chip import (
    MIG_MEMORY_SLICES,
    MIG_PROFILE_BY_LABEL,
    GpuInfo,
    NodeGpuInfo,
    VfioGpuInfo,
    mig_profile,
)
from k8s_dra_driver_tpu_torch.gpulib.device_lib import (
    DeviceLib,
    FakeVfioKernel,
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
    DEVICE_METADATA,
    DYNAMIC_MIG,
    PASSTHROUGH_SUPPORT,
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
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.vfio import (
    VFIO_DRIVER,
    VfioPciManager,
)

logger = logging.getLogger(__name__)

DRIVER_NAME = "gpu.nvidia.com"

# How long a drained claim's PrepareAborted tombstone is kept (the CD
# plugin's PREPARE_ABORTED_TTL, generalized to the GPU plugin by the drain
# path): long enough to reject a stale kubelet prepare retry of the drained
# claim version.
PREPARE_ABORTED_TTL = 10 * 60.0

# Per-device env of a passthrough device (the JAX package's
# TPU_PASSTHROUGH).
PASSTHROUGH_DEVICE_ENV = "GPU_PASSTHROUGH"

# Set to "1" in a plugin process that serves a materialized tree: the VFIO
# manager's kernel reaction is emulated (:attr:`DeviceState.vfio`).
ENV_FAKE_VFIO_KERNEL = "GPU_DRA_FAKE_VFIO_KERNEL"

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
    gpus_by_index: dict[int, GpuInfo]
    vfio_gpus: tuple[VfioGpuInfo, ...]
    vfio_by_name: dict[str, VfioGpuInfo]


def parse_mig_name(name: str) -> Optional[tuple[int, str, int, int]]:
    """``gpu-<index>-mig-<profile label>-<start>-<size>`` → (index,
    profile, start, size), the profile by its published name; None for any
    other name. A name that spells the profile itself
    (``gpu-0-mig-3g.40gb-0-4``, the form a checkpoint written before
    device names became DNS labels holds) parses to the same tuple."""
    head, sep, tail = name.partition("-mig-")
    if not sep or not head.startswith("gpu-"):
        return None
    parts = tail.rsplit("-", 2)
    try:
        return (int(head[4:]), MIG_PROFILE_BY_LABEL.get(parts[0], parts[0]),
                int(parts[1]), int(parts[2]))
    except (ValueError, IndexError):
        return None


def _slice_ids(gpu_index: int, start: int = 0,
               size: int = MIG_MEMORY_SLICES) -> set[str]:
    return {f"gpu:{gpu_index}/mem:{s}" for s in range(start, start + size)}


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
        retract_discarded: Optional[Callable[[ClaimRef], object]] = None,
    ):
        self.device_lib = device_lib
        self._retract_discarded = retract_discarded
        # Built at the first passthrough prepare (:attr:`vfio`); a test
        # sets a manager over a materialized tree here first.
        self._vfio: Optional[VfioPciManager] = None
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
        # Short shared-state lock: guards the enumeration snapshot swap and
        # the lazy VFIO manager. Never held across a prepare.
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
        # Only a passthrough node scans for vfio-bound functions.
        vfio_gpus = (tuple(self.device_lib.vfio_gpus())
                     if self.gates.enabled(PASSTHROUGH_SUPPORT) else ())
        enum = _Enumeration(
            node_info=self.device_lib.node_info(),
            gpus=gpus,
            gpus_by_name=sanitizer.track_state(
                {g.canonical_name: g for g in gpus},
                "DeviceState.enum.gpus_by_name"),
            gpus_by_index=sanitizer.track_state(
                {g.index: g for g in gpus}, "DeviceState.enum.gpus_by_index"),
            vfio_gpus=vfio_gpus,
            vfio_by_name=sanitizer.track_state(
                {v.canonical_name: v for v in vfio_gpus},
                "DeviceState.enum.vfio_by_name"),
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

    @property
    def vfio_gpus(self) -> list[VfioGpuInfo]:
        return list(self._enum.vfio_gpus)

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

    @property
    def vfio(self) -> VfioPciManager:
        """Lazy, so a node that never sees a passthrough claim never touches
        the VFIO sysfs surface (NewVfioPciManager is likewise conditional,
        device_state.go:195-198). Created under the state lock: concurrent
        passthrough prepares share one manager. ``GPU_DRA_FAKE_VFIO_KERNEL=1``
        swaps in the emulation of the kernel's reaction to the bind/unbind
        writes, so a plugin process drives the whole VFIO path against a
        materialized tree (the local cluster's gpu-test6; the JAX package's
        ``TPU_DRA_FAKE_VFIO_KERNEL``): every driver line is real, only the
        kernel's relinking is simulated."""
        with self._mu:
            if self._vfio is None:
                sysfs = getattr(self.device_lib, "sysfs_root", "/sys")
                dev = getattr(self.device_lib, "dev_root", "/dev")
                kernel = None
                if os.environ.get(ENV_FAKE_VFIO_KERNEL) == "1":
                    kernel = FakeVfioKernel(sysfs, dev)
                self._vfio = VfioPciManager(sysfs_root=sysfs, dev_root=dev,
                                            kernel=kernel)
            return self._vfio

    # -- startup ------------------------------------------------------------

    def _bootstrap_checkpoint(self) -> None:
        """Boot-id invalidation via the shared helper; on a reboot the
        artifact to heal per claim is its CDI spec (MIG instances do not
        survive a reboot, and the startup sweep destroys any that did).
        ``retract_discarded`` runs first for each discarded claim: the
        driver retracts its Ready status there, before the reset checkpoint
        drops the record."""
        def discard(uid: str, pc: PreparedClaimCP) -> None:
            if self._retract_discarded is not None:
                self._retract_discarded(ClaimRef(
                    uid=uid, name=pc.name, namespace=pc.namespace))
            self.cdi.delete_claim_spec_file(uid)

        with self.lock.held(timeout=10.0):
            bootstrap_checkpoint(self.checkpoints, self.node_boot_id,
                                 on_discard=discard)

    def sweep_unknown_claim_artifacts(self) -> list[str]:
        """Startup sweep (DestroyUnknownMIGDevices, device_state.go:448):
        delete CDI spec files not backed by a checkpointed claim and, under
        DynamicMIG, destroy the MIG instances no completed claim recorded
        (a crash between create and the checkpoint leaves one; a claim
        still in PrepareStarted rolls back on its retry and needs none).
        Without DynamicMIG the plugin creates none and leaves an admin's
        alone. Returns the swept claim UIDs and MIG UUIDs."""
        with self.lock.held(timeout=10.0):
            cp = self.checkpoints.read()
            known = set(cp.prepared_claims)
            removed = list(self.cdi.sweep_invalid_spec_files())
            for uid in self.cdi.list_claim_uids():
                if uid not in known:
                    self.cdi.delete_claim_spec_file(uid)
                    removed.append(uid)
            if self.gates.enabled(DYNAMIC_MIG):
                held = {d["mig"].get("uuid")
                        for pc in cp.prepared_claims.values()
                        if pc.state == STATE_PREPARE_COMPLETED
                        for d in pc.prepared_devices if d.get("mig")}
                for m in self.device_lib.mig_devices():
                    if m.uuid not in held:
                        self.device_lib.destroy_mig_device(m)
                        removed.append(m.uuid)
            if removed:
                logger.info("swept %d unknown claim artifacts: %s",
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
        with_md = self.gates.enabled(DEVICE_METADATA)
        return [
            pd.to_ref(self.cdi.qualified_id(pd.cdi_device_name),
                      with_metadata=with_md)
            for pd in prepared
        ]

    def _own_results(self, claim: Obj) -> list[dict[str, Any]]:
        return [r for r in claim_allocation_results(claim)
                if r.get("driver") == self.driver_name]

    @staticmethod
    def _device_phys_ids(name: str, enum: _Enumeration) -> set[str]:
        """Physical identities behind a DRA device name: a whole GPU is its
        eight ``gpu:<index>/mem:<slice>`` memory slices plus ``pci:<bdf>``
        when known; a MIG device the slices of its placement (its name
        encodes them, so a vanished parent still maps); a published
        passthrough device its ``pci:<bdf>`` alone (its scan index aliases
        GPU indices, so the PCI address is its only trustworthy identity).
        Unknown names map to empty (cross-driver results are filtered out
        before this)."""
        g = enum.gpus_by_name.get(name)
        if g is not None:
            out = _slice_ids(g.index)
            if g.pci_address:
                out.add(f"pci:{g.pci_address}")
            return out
        v = enum.vfio_by_name.get(name)
        if v is not None:
            return {f"pci:{v.pci_address}"}
        mig = parse_mig_name(name)
        if mig is not None:
            index, _, start, size = mig
            return _slice_ids(index, start, size)
        return set()

    @staticmethod
    def _held_phys_ids(pc: PreparedClaimCP) -> set[str]:
        """Identities a checkpointed claim holds, from prepare-time records
        (re-deriving from live enumeration would silently drop a claim's
        GPUs once one dies, disabling the overlap check). The records keep
        the checkpoint format's ``chipIndices`` key for the GPU index; a
        MIG record holds only its placement's slices."""
        held: set[str] = set()
        for d in pc.prepared_devices:
            mig = d.get("mig") or {}
            for i in d.get("chipIndices") or []:
                held |= (_slice_ids(i, mig["placementStart"],
                                    mig["placementSize"]) if mig
                         else _slice_ids(i))
            bdf = (d.get("vfio") or {}).get("pciAddress")
            if bdf:
                held.add(f"pci:{bdf}")
        for bdf in pc.vfio_restore or {}:
            held.add(f"pci:{bdf}")
        return held

    def _validate_no_overlap(self, cp: Checkpoint, uid: str,
                             results: list[dict[str, Any]],
                             enum: _Enumeration) -> None:
        """The same PHYSICAL memory slice or PCI function prepared under
        two different claims is a scheduler race or force-delete artifact;
        fail loudly (validateNoOverlappingPreparedDevices,
        device_state.go:1484). Comparison is at physical-identity
        granularity, not device-name granularity: a whole-GPU claim and a
        MIG claim on that GPU overlap though their names differ, two
        disjoint MIG claims on one GPU do not, and a GPU claim clashes with
        a passthrough claim on its function. Runs inside the registration
        transaction, so concurrent prepares validate against each other's
        records."""
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
        """Undo a partially executed prepare: restore any vfio-pci binds via
        the checkpointed restore ledger (the partial-VFIO rollback,
        device_state.go:621-655), destroy the MIG instances at the claim's
        placements, then delete the CDI spec
        (unpreparePartiallyPrepairedClaim, device_state.go:612-700)."""
        self._undo_devices(pc)
        self.checkpoints.transact(
            lambda c: c.prepared_claims[uid].vfio_restore.clear()
            if uid in c.prepared_claims else None)
        self.cdi.delete_claim_spec_file(uid)

    def _undo_devices(self, pc: PreparedClaimCP) -> None:
        """Release what a claim's prepare did to the devices: rebind its
        vfio-bound functions and destroy its MIG instances. Raises
        (retryably) on failure — the claim record stays until the undo
        actually succeeds."""
        self._restore_vfio(pc)
        self._destroy_migs(pc)

    def _restore_vfio(self, pc: PreparedClaimCP) -> None:
        """Rebind every function this claim moved to vfio-pci back to its
        recorded original driver."""
        for bdf, original in (pc.vfio_restore or {}).items():
            if original:
                self.vfio.unconfigure(bdf, original)

    def _destroy_migs(self, pc: PreparedClaimCP) -> None:
        """Destroy the claim's MIG instances: those its completed records
        name by UUID (an id the driver reused for another instance is never
        touched), and, for a prepare that did not complete, any instance at
        exactly one of its allocated placements — the registration
        transaction gave the claim those slices alone. Idempotent."""
        uuids = {d["mig"].get("uuid") for d in pc.prepared_devices
                 if d.get("mig")}
        placements = set()
        if pc.state != STATE_PREPARE_COMPLETED:
            for r in pc.results:
                mig = parse_mig_name(r.get("device", ""))
                if mig is not None:
                    placements.add((mig[0], mig[2], mig[3]))
        if not uuids and not placements:
            return
        for m in self.device_lib.mig_devices():
            if m.uuid in uuids or (m.parent_index, m.start,
                                   m.size) in placements:
                self.device_lib.destroy_mig_device(m)
                logger.info("destroyed MIG instance %s (%s at %d on GPU %d)",
                            m.uuid, m.profile, m.start, m.parent_index)

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
        """Route each allocated device (the JAX package's
        ``_prepare_devices``): a published passthrough device, a whole GPU
        (for passthrough when its configs hold a VfioDeviceConfig), or a
        MIG placement."""
        uid = claim_uid(claim)
        prepared: list[PreparedDevice] = []
        for r in results:
            name = r.get("device", "")
            configs = self._configs_for(claim, r.get("request", ""))
            wants_vfio = any(isinstance(c, VfioDeviceConfig)
                             for c in configs)
            if name in enum.vfio_by_name:
                # A pre-bound function: its scan index is positional, so
                # no GPU index — the PCI address is its identity.
                prepared.append(self._prepare_gpu_vfio(
                    uid, r, configs, None,
                    enum.vfio_by_name[name].pci_address))
            elif name in enum.gpus_by_name:
                gpu = enum.gpus_by_name[name]
                prepared.append(
                    self._prepare_gpu_vfio(uid, r, configs, gpu.index,
                                           gpu.pci_address)
                    if wants_vfio else self._prepare_gpu(uid, r, configs,
                                                         enum))
            elif parse_mig_name(name) is not None:
                prepared.append(self._prepare_mig(uid, r, configs, enum))
            else:
                raise PermanentError(f"allocated device {name!r} is not an "
                                     f"allocatable device on this node")
        return prepared

    @staticmethod
    def _config_env(name: str, configs: list[Any], own: type) -> dict:
        """The env of the device's GpuConfigs and of its ``own`` config
        kind, later configs winning; a config of another kind cannot target
        the device and is a PermanentError (the reference's config/device
        type mismatch refusal, device_state.go:874)."""
        env: dict[str, str] = {}
        for cfg in configs:
            if isinstance(cfg, (GpuConfig, own)):
                env.update(getattr(cfg, "env", {}))
            else:
                raise PermanentError(
                    f"{type(cfg).__name__} cannot target device {name}")
        return env

    def _prepare_gpu(self, uid: str, result: dict[str, Any],
                     configs: list[Any],
                     enum: _Enumeration) -> PreparedDevice:
        """One whole GPU: its ``/dev/nvidia<minor>`` node and the driver's
        control nodes (the per-device edits of :func:`claim_edits_for`),
        plus the env of the claim's GpuConfigs, later ones winning."""
        name = result["device"]
        gpu = enum.gpus_by_name[name]
        env = self._config_env(name, configs, GpuConfig)
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

    def _prepare_mig(self, uid: str, result: dict[str, Any],
                     configs: list[Any],
                     enum: _Enumeration) -> PreparedDevice:
        """One MIG placement (the JAX package's ``_prepare_subslice``):
        DynamicMIG creates the instance here. Its edits are the parent's
        node and the instance's ``nvidia-caps`` nodes; a MigDeviceConfig
        whose profile is not the device's is a PermanentError."""
        name = result["device"]
        if not self.gates.enabled(DYNAMIC_MIG):
            raise PermanentError(f"MIG device {name}: feature gate "
                                 f"{DYNAMIC_MIG} is disabled on this node")
        index, profile, start, size = parse_mig_name(name)
        gpu = enum.gpus_by_index.get(index)
        if gpu is None:
            raise PermanentError(
                f"MIG device {name} names GPU {index}, not present on this "
                "node")
        try:
            p = mig_profile(gpu.gpu_type, profile)
        except ValueError as e:
            raise PermanentError(f"MIG device {name}: {e}") from e
        if start not in p.starts or size != p.size:
            raise PermanentError(f"MIG device {name}: {profile} has no "
                                 f"placement {start}+{size}")
        for cfg in configs:
            if isinstance(cfg, MigDeviceConfig) and cfg.profile \
                    and cfg.profile != profile:
                raise PermanentError(
                    f"claim requests MIG profile {cfg.profile} but "
                    f"allocated device {name} has profile {profile}")
        env = self._config_env(name, configs, MigDeviceConfig)
        mig = self.device_lib.create_mig_device(gpu, profile, start)
        logger.info("created MIG instance %s (%s at %d on GPU %d) for claim "
                    "%s", mig.uuid, profile, start, index, uid)
        edits = mig_device_edits(name, gpu.minor, mig.caps_paths)
        return PreparedDevice(
            device=name,
            requests=[result.get("request", "")],
            pool=self.pool_name,
            cdi_device_name=self.cdi.claim_device_name(uid, name),
            device_nodes=list(edits.device_nodes),
            env=env,
            chip_indices=[gpu.index],
            mig=mig.to_dict(),
        )

    def _prepare_gpu_vfio(self, uid: str, result: dict[str, Any],
                          configs: list[Any], gpu_index: Optional[int],
                          bdf: str) -> PreparedDevice:
        """Passthrough prepare (the JAX package's ``_prepare_chip_vfio``):
        bind the GPU's PCI function to vfio-pci and hand the container the
        VFIO group cdev instead of ``/dev/nvidia<minor>``; the claim-wide
        IOMMU API node is added once at the claim level
        (prepareVfioDevices, device_state.go:905-960; node shape per
        vfio-cdi.go:52-110)."""
        name = result["device"]
        if not self.gates.enabled(PASSTHROUGH_SUPPORT):
            raise PermanentError(
                f"VFIO passthrough of device {name}: feature gate "
                f"{PASSTHROUGH_SUPPORT} is disabled on this node")
        if not bdf:
            raise PermanentError(
                f"device {name} has no PCI address; cannot passthrough")
        vfio_cfgs = [c for c in configs if isinstance(c, VfioDeviceConfig)]
        prefer_iommufd = bool(vfio_cfgs) and \
            vfio_cfgs[-1].iommu == IOMMU_IOMMUFD
        env = self._config_env(name, configs, VfioDeviceConfig)
        env[PASSTHROUGH_DEVICE_ENV] = "1"

        mgr = self.vfio
        original = mgr.current_driver(bdf)
        if original == VFIO_DRIVER:
            original = ""  # pre-bound (admin); never unbind at unprepare
        # Ledger BEFORE bind: a crash between the checkpoint write and the
        # bind leaves a harmless no-op restore; the reverse order would leak
        # a vfio-bound GPU with no record of how to restore it.
        self.checkpoints.transact(
            lambda c: c.prepared_claims[uid].vfio_restore.__setitem__(
                bdf, original))
        mgr.configure(bdf)  # VfioError is retryable; let it propagate

        group_node = mgr.vfio_device_node(bdf)
        backend = (IOMMU_IOMMUFD
                   if mgr.iommu_api_node(prefer_iommufd) == "/dev/iommu"
                   else IOMMU_LEGACY)
        # iommufd mode injects the per-device iommufd cdev
        # (/dev/vfio/devices/vfioN): the legacy group cdev cannot be opened
        # through the iommufd API a VMM handed /dev/iommu uses
        # (vfio-cdi.go:96-106). Retryable when the cdev has not appeared.
        device_node = (mgr.iommufd_device_node(bdf)
                       if backend == IOMMU_IOMMUFD else group_node)
        return PreparedDevice(
            device=name,
            requests=[result.get("request", "")],
            pool=self.pool_name,
            cdi_device_name=self.cdi.claim_device_name(uid, name),
            device_nodes=[device_node],
            env=env,
            chip_indices=[] if gpu_index is None else [gpu_index],
            vfio={"pciAddress": bdf,
                  "iommuGroup": group_node.rsplit("/", 1)[-1],
                  "iommu": backend},
        )

    @staticmethod
    def _claim_edits(prepared: list[PreparedDevice],
                     enum: _Enumeration) -> CDIDevice:
        """Claim-wide edits (:func:`claim_visibility_edits`):
        ``CUDA_VISIBLE_DEVICES`` and ``NVIDIA_VISIBLE_DEVICES`` list the
        claim's whole GPUs by UUID in node index order, then its MIG
        instances' ``MIG-<uuid>``; passthrough devices are left out (their
        nodes are gone once vfio-bound) and go in the PCI-address variable,
        with ONE IOMMU API node per claim (GetCommonEdits,
        vfio-cdi.go:52-79): iommufd only when every passthrough device
        resolved to it, else the claim-consistent legacy container."""
        whole = sorted({enum.gpus_by_name[pd.device].index:
                        enum.gpus_by_name[pd.device].uuid
                        for pd in prepared
                        if not pd.vfio and not pd.mig}.items())
        visible = [u for _, u in whole] + [pd.mig["uuid"] for pd in prepared
                                           if pd.mig]
        vfio_pds = [pd for pd in prepared if pd.vfio]
        iommu_node = ""
        if vfio_pds:
            iommu_node = ("/dev/iommu" if all(
                pd.vfio.get("iommu") == IOMMU_IOMMUFD for pd in vfio_pds)
                else "/dev/vfio/vfio")
        return claim_visibility_edits(
            visible, [pd.vfio["pciAddress"] for pd in vfio_pds], iommu_node)

    def claimed_vfio_bdfs(self) -> set[str]:
        """PCI functions tied to ANY checkpointed claim — publication keeps
        a GPU this plugin vfio-bound for a live claim from resurfacing as a
        fresh allocatable passthrough device. Lock-free read: publication
        must not queue behind a prepare."""
        out: set[str] = set()
        try:
            claims = self.prepared_claims_nolock()
        except Exception:  # noqa: BLE001 — unreadable state already fails
            # requests loudly elsewhere; publication just stays conservative.
            return out
        for pc in claims.values():
            out.update(pc.vfio_restore or {})
            for d in pc.prepared_devices:
                bdf = (d.get("vfio") or {}).get("pciAddress")
                if bdf:
                    out.add(bdf)
        return out

    def _refs_from_checkpoint(self, uid: str,
                              pc: PreparedClaimCP) -> list[PreparedDeviceRef]:
        out = []
        with_md = self.gates.enabled(DEVICE_METADATA)
        for d in pc.prepared_devices:
            pd = PreparedDevice.from_dict(d)
            out.append(pd.to_ref(self.cdi.qualified_id(pd.cdi_device_name),
                                 with_metadata=with_md))
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
            # Undo BEFORE dropping the record: a failed restore or destroy
            # leaves the claim checkpointed so the kubelet retries unprepare.
            self._undo_devices(pc)
            self.cdi.delete_claim_spec_file(ref.uid)
            self.checkpoints.transact(
                lambda c: c.prepared_claims.pop(ref.uid, None))

    # -- drain (self-healing remediation, docs/self-healing.md) --------------

    def drain(self, ref: ClaimRef, reason: str = "",
              retract: Optional[Callable[[], object]] = None) -> bool:
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
        (idempotent) undo and commits the tombstone.

        ``retract``: called under the flight lock before any undo, when
        there is something to drain — the driver retracts the claim's Ready
        status there, so that no reader sees Ready for a claim whose record
        is no longer a completed prepare. A raise aborts the drain with
        nothing undone (the caller retries)."""
        with self._flights.claim(ref.uid):
            cp = self.checkpoints.read_cached()
            pc = cp.prepared_claims.get(ref.uid)
            if pc is None or pc.state == STATE_PREPARE_ABORTED:
                return False
            if retract is not None:
                retract()
            self._undo_devices(pc)
            self.cdi.delete_claim_spec_file(ref.uid)
            expiry = self.clock() + self.aborted_ttl

            def mark(c: Checkpoint) -> bool:
                entry = c.prepared_claims.get(ref.uid)
                if entry is None or entry.state == STATE_PREPARE_ABORTED:
                    return False
                entry.state = STATE_PREPARE_ABORTED
                entry.prepared_devices = []
                entry.vfio_restore = {}
                entry.aborted_expiry = expiry
                return True

            drained = bool(self.checkpoints.transact(mark))
            if drained:
                logger.info("drained claim %s off this node%s", ref.uid,
                            f" ({reason})" if reason else "")
            return drained

    def while_prepared(self, uid: str, devices: list[str],
                       fn: Callable[[], None]) -> bool:
        """Run ``fn`` under the claim's flight lock if the checkpoint holds
        ``uid`` as a completed prepare of exactly ``devices``; returns
        whether it ran. A drain or an unprepare of the claim holds the same
        lock, so none lands between the check and ``fn``: the claim
        watcher publishes Ready through here."""
        with self._flights.claim(uid):
            pc = self.checkpoints.read_cached().prepared_claims.get(uid)
            if (pc is None or pc.state != STATE_PREPARE_COMPLETED
                    or sorted(d.get("device", "") for d in pc.prepared_devices)
                    != sorted(devices)):
                return False
            fn()
            return True

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
        validator's currency), so a MIG claim on a tainted GPU is found
        though its device name differs. A vanished GPU has no enumeration
        entry; its name still encodes the GPU index, which is exactly what
        the prepare-time records hold."""
        enum = self._enum
        want = self._device_phys_ids(device, enum)
        if not want and device.startswith("gpu-"):
            try:
                want = _slice_ids(int(device.split("-")[1]))
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
        """How many physical GPUs a prepared claim holds (a MIG claim its
        parent) — the drain controller's priority key
        (docs/self-healing.md, "Drain ordering"): small claims vacate a
        tainted device before multi-GPU ones. 0 for unknown/unreadable
        claims (sorts first: nothing to evict)."""
        try:
            pc = self.prepared_claims_nolock().get(uid)
        except Exception:  # noqa: BLE001 — unreadable state already
            # fails requests loudly elsewhere; ordering degrades to uid.
            return 0
        if pc is None:
            return 0
        held = self._held_phys_ids(pc)
        if not held:
            enum = self._enum
            for r in pc.results:
                held |= self._device_phys_ids(r.get("device", ""), enum)
        gpus = {h.split("/")[0] for h in held if h.startswith("gpu:")}
        if gpus or held:
            return len(gpus) or len(held)
        return max(len(pc.prepared_devices), len(pc.results))
